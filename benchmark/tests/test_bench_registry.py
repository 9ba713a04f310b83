"""A configuration, a traffic mix, a per-layer metric and a cell are added
as new files and new entries of BENCHMARK.json: no file the benchmark
already has is edited, and the harness finds each by its name."""

import filecmp
import json
import os

import bench_support
from harness.registry import Registry


def test_new_files_are_found_without_editing_any(tmp_path):
    root = bench_support.make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = {}
    for d, _dirs, files in os.walk(b):
        for f in files:
            before[os.path.join(d, f)] = open(os.path.join(d, f), "rb").read()
    # New files only: a configuration, a traffic mix, a metric reader, a
    # kernel count, a limits file; then new entries in BENCHMARK.json.
    with open(os.path.join(b, "configs", "dummy_cfg.json"), "w") as f:
        json.dump({"name": "dummy_cfg", "entry": "system_mono", "cameras": 1}, f)
    with open(os.path.join(b, "traffic", "dummy_mix.json"), "w") as f:
        json.dump({"path": [{"kind": "explore", "frames": 5}]}, f)
    with open(os.path.join(b, "metrics", "dummy.layer_metric.py"), "w") as f:
        f.write("def read(ctx):\n    return 42.0\n")
    with open(os.path.join(b, "kernels", "dummy_kernel.py"), "w") as f:
        f.write("TRACE_NAME = 'dummy_kernel'\nLAUNCHES_PER_FRAME_BUILD = 1\n")
    with open(os.path.join(b, "limits", "dummy_cfg.dummy_mix.json"), "w") as f:
        json.dump({"compare": {"kp_diff_pct": {"limit": 1.0}}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                             "file": "benchmark/configs/dummy_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "dummy.layer_metric", "unit": "%",
                               "better": "higher", "source": "program_counter",
                               "layer": "tracking", "moves": "kernel_ms_per_frame",
                               "workloads": ["dummy_cfg.dummy_mix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    reg = Registry(root)
    assert reg.workload("dummy_cfg.dummy_mix")["traffic"] == "dummy_mix"
    assert reg.config("dummy_cfg")["entry"] == "system_mono"
    assert reg.traffic("dummy_mix")["path"][0]["frames"] == 5
    assert reg.limits("dummy_cfg.dummy_mix")["compare"]["kp_diff_pct"]["limit"] == 1.0
    assert reg.metric_reader("dummy.layer_metric")(None) == 42.0
    assert reg.kernel("dummy_kernel").TRACE_NAME == "dummy_kernel"
    assert hasattr(reg.entry("system_mono"), "Entry")
    names = [m["name"] for m in reg.per_layer("dummy_cfg.dummy_mix")]
    assert "dummy.layer_metric" in names and "track.ms_per_frame" in names
    assert "dummy.layer_metric" not in [
        m["name"] for m in reg.per_layer("tum1_mono.explore")]
    assert [m["name"] for m in reg.end_to_end("tum1_mono.localize")] == [
        "kernel_ms_per_frame", "setup_s"]
    assert [m["name"] for m in reg.end_to_end("dummy_cfg.dummy_mix")] == [
        "kernel_ms_per_frame", "setup_s"]
    for path, data in before.items():
        assert open(path, "rb").read() == data, path


def test_every_name_in_benchmark_json_has_its_files():
    reg = Registry(bench_support.REPO)
    for w in reg.bench["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        assert hasattr(reg.entry(cfg["entry"]), "Entry")
        assert "path" in reg.traffic(w["traffic"])
        assert reg.limits(w["name"])["compare"]
        for m in reg.per_layer(w["name"]):
            assert callable(reg.metric_reader(m["name"]))
    for c in reg.bench["configs"]:
        assert set(c["reduced"]) <= set(reg.config(c["name"]))
    assert filecmp.cmp(os.path.join(bench_support.REPO, "BENCHMARK.json"),
                       os.path.join(bench_support.REPO, "BENCHMARK.json"))


def test_a_rig_configuration_is_found_as_new_files(tmp_path):
    """A stereo configuration, its traffic, limits and cell come as new
    files and entries: every file the benchmark had stays as it is."""
    root = bench_support.make_root(tmp_path, sensor="stereo")
    b = os.path.join(root, "benchmark")
    for d, _dirs, files in os.walk(bench_support.BENCH):
        rel = os.path.relpath(d, bench_support.BENCH)
        if rel.split(os.sep)[0] in ("tests", "__pycache__") or "__pycache__" in rel:
            continue
        for f in files:
            assert filecmp.cmp(os.path.join(d, f), os.path.join(b, rel, f),
                               shallow=False), os.path.join(rel, f)
    reg = Registry(root)
    cfg = reg.config(reg.workload("tiny_stereo.tiny_explore")["config"])
    assert cfg["sensor"] == "stereo" and cfg["camera"]["bf"] > 0
    entry = reg.entry(cfg["entry"])
    assert cfg["entry"] == "system_stereo" and hasattr(entry, "Entry")
    assert reg.traffic("tiny_explore")["path"]
    assert reg.limits("tiny_stereo.tiny_explore")["compare"]
    assert [m["name"] for m in reg.end_to_end("tiny_stereo.tiny_explore")] == [
        "kernel_ms_per_frame", "setup_s"]
