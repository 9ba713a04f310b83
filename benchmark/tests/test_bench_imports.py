"""Nothing the harness imports is JAX or the JAX package (compared by whole
top-level names: the port's own name begins with the JAX package's), and
the references import nothing of the program."""

import os
import subprocess
import sys

import bench_support

FORBIDDEN = {"jax", "jaxlib", "flax", "orb_slam_system_tpu"}


def _top_levels(code: str) -> set:
    src = (f"import sys\nsys.path[:0] = [{bench_support.BENCH!r}, "
           f"{bench_support.REPO!r}]\n{code}\n"
           "print(sorted({m.split('.')[0] for m in list(sys.modules)}))\n")
    out = subprocess.run([sys.executable, "-c", src], capture_output=True,
                         text=True, timeout=300, cwd=bench_support.REPO)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_entry_load_no_jax():
    names = _top_levels("""
import run
from harness import cell, control, judge, registry, roofline, scene, stats, tracing, layers
reg = registry.Registry(run.ROOT)
for w in reg.bench["workloads"]:
    cfg = reg.config(w["config"])
    reg.entry(cfg["entry"])
    for m in reg.per_layer(w["name"]):
        reg.metric_reader(m["name"])
for k in ("fast_score_nms", "gather_blur_describe"):
    reg.kernel(k)
from orb_slam_system_tpu_torch.models.system import System
from orb_slam_system_tpu_torch.parallel.multi_system import MultiSystem
""")
    assert "orb_slam_system_tpu_torch" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_references_load_nothing_of_the_program():
    names = _top_levels("""
from reference import orb, geometry, brief_pattern
from harness import judge, control
""")
    assert not names & (FORBIDDEN | {"orb_slam_system_tpu_torch"})
    ref = os.path.join(bench_support.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            text = open(os.path.join(ref, f)).read()
            assert "orb_slam_system_tpu" not in text, f


def test_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "orb_slam_system_tpu_torch.fake", object())
    assert run.loaded_forbidden() == sorted(
        {m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    monkeypatch.setitem(sys.modules, "orb_slam_system_tpu.fake", object())
    assert "orb_slam_system_tpu" in run.loaded_forbidden()


def test_reference_extractor_equals_the_ports_plain_extractor():
    import numpy as np
    import torch
    from reference import orb
    from orb_slam_system_tpu_torch.config import ORBConfig
    from orb_slam_system_tpu_torch.ops.extractor import ORBExtractor
    torch.set_num_threads(2)
    rng = np.random.default_rng(5)
    img = np.kron(rng.integers(0, 255, (30, 40)), np.ones((8, 8))).astype(np.uint8)
    img = (img * 0.7 + np.roll(img, 3, 1) * 0.3).astype(np.uint8)[None]
    fs = ORBExtractor(ORBConfig(n_features=400, n_levels=4), 240, 320)(
        torch.from_numpy(img).float())
    ref = orb.extract(torch.from_numpy(img), 400, 1.2, 4, 20, 7)
    assert torch.equal(fs.xy, ref.xy) and torch.equal(fs.valid, ref.valid)
    assert torch.equal(fs.octave.long(), ref.octave)
    assert torch.equal(fs.angle, ref.angle) and torch.equal(fs.desc, ref.desc)
