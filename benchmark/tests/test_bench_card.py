"""Each workload end to end on the card, through the command the driver
runs, with a short window: a correct result line whose keys and metrics are
those BENCHMARK.json gives the cell. Skips without a GPU."""

import json
import os
import subprocess
import sys

import pytest

import bench_support
from harness.registry import Registry

WORKLOADS = [w["name"] for w in Registry(bench_support.REPO).bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("trace", [0, 1])
def test_workload_on_the_card(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", "3999999999", "--seconds", "8", "--trace", str(trace)],
        cwd=bench_support.REPO, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    reg = Registry(bench_support.REPO)
    want = {m["name"] for m in (reg.per_layer(workload) if trace
                                else reg.end_to_end(workload))}
    assert set(res["metrics"]) == want
    assert res["device"]["platform"] == "gpu"
    assert list(res)[-1] == "checks"
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert os.path.isdir(os.path.join(bench_support.REPO, "build", "torch_kernels"))
