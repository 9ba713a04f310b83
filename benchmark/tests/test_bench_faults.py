"""The check that decides `correct`, driven through a whole run at a size a
test run holds (the CPU, 320x240, 400 features), with the chip's look left
out: a sound run passes; the control and each fault the cells can have
fail. Faults are planted in the program underneath the harness."""

import pytest

import bench_support
from harness import control, faults, judge


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return {1: bench_support.make_root(tmp_path_factory.mktemp("one")),
            2: bench_support.make_root(tmp_path_factory.mktemp("two"), n_cameras=2)}


def test_sound_run_is_correct(roots):
    r = bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


def test_control_fails(roots):
    got = {}
    bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore", seed=3000000002,
                           on_check=lambda **kw: got.update(control.numbers(**kw)))
    from harness.registry import Registry
    ok, checks = judge.verdict(got, Registry(roots[1]).limits("tiny_mono.tiny_explore"))
    assert not ok, checks


def test_state_returned_unchanged_fails(roots, monkeypatch):
    faults.plant("pose_unchanged", monkeypatch.setattr)
    r = bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore")
    assert not r["correct"], r["checks"]


def test_half_of_the_batch_left_out_fails(roots, monkeypatch):
    faults.plant("pose_unchanged", monkeypatch.setattr, cameras={1})
    r = bench_support.run_tiny(roots[2], "tiny_x2.tiny_explore")
    assert not r["correct"], r["checks"]


def test_descriptor_altered_where_produced_fails(roots, monkeypatch):
    faults.plant("descriptor_altered", monkeypatch.setattr)
    r = bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore")
    assert not r["correct"], r["checks"]


def test_local_ba_skipped_fails(roots, monkeypatch):
    faults.plant("local_ba_skipped", monkeypatch.setattr)
    r = bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore")
    assert not r["correct"], r["checks"]


def test_pose_dropped_fails(roots, monkeypatch):
    faults.plant("pose_dropped", monkeypatch.setattr)
    r = bench_support.run_tiny(roots[1], "tiny_mono.tiny_explore")
    assert not r["correct"], r["checks"]
    assert r["failed"] > 0
