"""Sequences from disk in the port: the dataset listings, the native
decoder, the prefetch ring, the layout detection, EuRoC rectification and
the ATE tool, each against the JAX package's counterpart on the same files
(tests/test_datasets_drivers.py, tests/test_native.py,
tests/test_run_dataset.py::test_detect_layouts and
tests/test_stereo_euroc.py:38-112 mirrored on the port). Plus one test for
each fault of the JAX flow that the port repairs: the EuRoC folder, the
KITTI-mono ground-truth stamps and the hidden decode failures.

The native decoder is built with g++ at first use; these tests skip,
naming the reason, only where g++ or zlib is missing.
"""

import ctypes.util
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from examples import stereo_euroc as jstereo_euroc  # noqa: E402
from orb_slam_system_tpu.config import Sensor as JSensor  # noqa: E402
from orb_slam_system_tpu.config import load_settings as jload_settings  # noqa: E402
from orb_slam_system_tpu.dataio import datasets as jdatasets  # noqa: E402
from orb_slam_system_tpu.models import viewer as jviewer  # noqa: E402
from orb_slam_system_tpu_torch import native  # noqa: E402
from orb_slam_system_tpu_torch.config import Sensor, load_settings  # noqa: E402
from orb_slam_system_tpu_torch.dataio import datasets, layouts  # noqa: E402
from orb_slam_system_tpu_torch.drivers import (evaluate_ate,  # noqa: E402
                                               run_dataset, stereo_euroc)
from orb_slam_system_tpu_torch.drivers._driver_util import make_fetcher  # noqa: E402
from orb_slam_system_tpu_torch.models import viewer  # noqa: E402
from tools import evaluate_ate as jevaluate_ate  # noqa: E402
from tools import run_dataset as jrun_dataset  # noqa: E402

SETTINGS = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "settings")


@pytest.fixture(scope="module")
def have_native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native decoder cannot build")
    if ctypes.util.find_library("z") is None:
        pytest.skip("zlib is not installed: the native decoder cannot link")
    native.library()
    return True


# ---- listings --------------------------------------------------------------

def _tum_seq(tmp_path):
    seq = tmp_path / "tum"
    seq.mkdir(parents=True)
    (seq / "rgb.txt").write_text(
        "# color images\n# file: 'x.bag'\n# timestamp filename\n"
        "1305031102.175304 rgb/1305031102.175304.png\n\n"
        "1305031102.211214 rgb/1305031102.211214.png extra\n"
        "# a comment inside\n1305031102.243211 rgb/1305031102.243211.png\n")
    (seq / "assoc.txt").write_text(
        "1.0 rgb/1.0.png 1.01 depth/1.01.png\n# skipped\n\n"
        "2.0 rgb/2.0.png 2.01 depth/2.01.png\n")
    (seq / "groundtruth.txt").write_text(
        "# ground truth\n1305031098.6659 1.3563 0.6305 1.6380 0.6132 0.5962 "
        "-0.3311 -0.3986\n\n1305031098.6758 1.3543 0.6306 1.6360 0.6129 "
        "0.5966 -0.3316 -0.3980\n")
    return seq


def _listing(case, tmp_path, pkg):
    if case in ("tum_rgb", "associations", "groundtruth"):
        seq = _tum_seq(tmp_path)
        if case == "tum_rgb":
            return pkg.load_tum_rgb(str(seq))
        if case == "associations":
            return pkg.load_tum_associations(str(seq), str(seq / "assoc.txt"))
        return pkg.load_tum_groundtruth(str(seq / "groundtruth.txt"))
    if case.startswith("kitti"):
        seq = tmp_path / "00"
        seq.mkdir(parents=True)
        (seq / "times.txt").write_text(
            "0.000000e+00\n1.037359e-01\n\n2.073518e-01\n")
        return pkg.load_kitti(str(seq), stereo=case == "kitti_stereo")
    cam = tmp_path / "mav0" / "cam0"
    cam.mkdir(parents=True, exist_ok=True)
    ts = tmp_path / "MH01.txt"   # its folder exists (cam0's parents)
    # Plain ns lines (EuRoC_TimeStamps), data.csv rows and a comment.
    ts.write_text("#timestamp [ns],filename\n1403636579763555584\n"
                  "1403636579813555456,1403636579813555456.png\n\n"
                  "1403636579863555584.png\n")
    return pkg.load_euroc(str(cam), str(ts))


def _equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("case", ["tum_rgb", "associations", "groundtruth",
                                  "kitti_mono", "kitti_stereo", "euroc"])
def test_listing_equals_jax(case, tmp_path):
    """The port's readers give the JAX readers' lists exactly: paths,
    times (float parse, the EuRoC ns parse), comment and blank lines."""
    got = _listing(case, tmp_path / "port", datasets)
    want = _listing(case, tmp_path / "jax", jdatasets)
    got = _rebase(got, tmp_path / "port", tmp_path / "jax")
    _equal(got, want)
    assert len(got[0] if isinstance(got, tuple) else got) >= 2


def _rebase(x, old, new):
    """Swap the folder prefix in listed paths (each package wrote its own)."""
    if isinstance(x, tuple):
        return tuple(_rebase(v, old, new) for v in x)
    if isinstance(x, list):
        return [_rebase(v, old, new) for v in x]
    if isinstance(x, str):
        return x.replace(str(old), str(new))
    return x


# ---- the native decoder ----------------------------------------------------

def _pnm(path, img, maxval, magic="P5"):
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    with open(path, "wb") as f:
        f.write(f"{magic}\n# comment\n{img.shape[1]} {img.shape[0]}\n"
                f"{maxval}\n".encode())
        f.write(img.astype(dtype).tobytes())


@pytest.mark.parametrize("kind", ["pgm8", "pgm16_raw", "pgm16", "ppm"])
def test_native_pnm_equals_python_reader(kind, tmp_path, rng, have_native):
    """The native decoder gives exactly _load_pnm's arrays (8-bit, 16-bit
    raw and scaled to [0, 255], RGB to gray)."""
    p = str(tmp_path / "x.pnm")
    raw = kind == "pgm16_raw"
    if kind == "pgm8":
        _pnm(p, rng.integers(0, 256, (33, 47)), 255)
    elif kind == "ppm":
        _pnm(p, rng.integers(0, 256, (21, 30, 3)), 255, "P6")
    else:
        _pnm(p, rng.integers(0, 65536, (19, 23)), 65535)
    want = datasets._load_pnm(p, raw=raw)
    got = native.decode_gray(p, raw16=raw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        datasets.load_depth_raw(p) if raw else datasets.load_image_gray(p),
        want)


@pytest.mark.parametrize("writer", ["encode_png", "pil"])
@pytest.mark.parametrize("kind", ["gray8", "rgb8", "gray16"])
def test_native_png_exact(writer, kind, tmp_path, rng, have_native):
    """8-bit gray and RGB PNGs, and a 16-bit PNG read raw, from the port's
    encode_png and from PIL (adaptive row filters), decode to exactly the
    pixels (RGB through the 0.299 / 0.587 / 0.114 weights in double)."""
    if kind == "gray8":
        img = rng.integers(0, 256, (21, 38)).astype(np.uint8)
    elif kind == "rgb8":
        img = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    else:
        img = rng.integers(0, 65536, (12, 17)).astype(np.uint16)
    p = tmp_path / "a.png"
    if writer == "pil":
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(img).save(str(p))
    else:
        p.write_bytes(viewer.encode_png(img))
    if kind == "rgb8":
        x = img.astype(np.float64)
        want = (0.299 * x[..., 0] + 0.587 * x[..., 1]
                + 0.114 * x[..., 2]).astype(np.float32)
    else:
        want = img.astype(np.float32)
    got = native.decode_gray(str(p), raw16=kind == "gray16")
    np.testing.assert_array_equal(got, want)


def test_writers_equal_jax(tmp_path, rng):
    """write_pgm and encode_png of u8 images write the JAX viewer's bytes."""
    for img in (rng.uniform(-20, 300, (9, 11)),
                rng.integers(0, 256, (7, 5, 3)).astype(np.uint8)):
        assert viewer.encode_png(img) == jviewer.encode_png(img)
    img = rng.uniform(0, 255, (9, 11))
    viewer.write_pgm(str(tmp_path / "a.pgm"), img)
    jviewer.write_pgm(str(tmp_path / "b.pgm"), img)
    assert (tmp_path / "a.pgm").read_bytes() == (tmp_path / "b.pgm").read_bytes()


def test_prefetcher_ordered(tmp_path, have_native):
    paths = []
    for i in range(10):
        p = tmp_path / f"f{i}.png"
        p.write_bytes(viewer.encode_png(np.full((6, 8), i * 7, np.uint8)))
        paths.append(str(p))
    with native.PrefetchLoader(paths, depth=4) as pl:
        for i in range(10):
            f = pl.fetch(i)
            assert f.shape == (6, 8) and float(f[0, 0]) == i * 7


def test_prefetcher_slow_consumer_no_deadlock(tmp_path, have_native):
    """tests/test_native.py's regression on the port: frame 0 decodes
    slowest, so the other workers fill the ring first; the consumer's
    index must still get through the capacity gate."""
    paths = []
    viewer.write_pgm(str(tmp_path / "f000.pgm"), np.zeros((400, 500)))
    paths.append(str(tmp_path / "f000.pgm"))
    for i in range(1, 30):
        p = tmp_path / f"f{i:03d}.pgm"
        viewer.write_pgm(str(p), np.full((6, 8), i))
        paths.append(str(p))
    pl = native.PrefetchLoader(paths, depth=8)
    time.sleep(0.3)          # let the ring fill while the consumer idles
    done = {"ok": False}

    def consume():
        for i in range(30):
            assert float(pl.fetch(i)[0, 0]) == (i if i else 0)
            time.sleep(0.01)  # slow consumer
        done["ok"] = True

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive() and done["ok"], "the prefetch ring deadlocked"
    pl.close()


def test_decode_failures_raise(tmp_path, have_native):
    """Fault 4 of the JAX flow (examples/_driver_util.py:12-25,
    dataio/datasets.py:33-36): a frame that cannot be decoded, or a decoder
    that cannot be built, raises naming the cause; nothing falls back."""
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 40)
    missing = str(tmp_path / "missing.png")
    for call in (lambda: native.decode_gray(str(bad)),
                 lambda: datasets.load_image_gray(missing),
                 lambda: datasets.load_depth_raw(str(bad))):
        with pytest.raises(RuntimeError, match="native decode failed"):
            call()
    good = tmp_path / "good.png"
    good.write_bytes(viewer.encode_png(np.zeros((4, 4), np.uint8)))
    with make_fetcher([str(good), str(bad)]) as fetch:
        assert fetch.fetch(0).shape == (4, 4)
        with pytest.raises(RuntimeError, match="bad.png"):
            fetch.fetch(1)
    broken = tmp_path / "broken.cpp"
    broken.write_text("int sd_decode( {\n")
    with pytest.raises(RuntimeError, match="error"):
        native.build(broken, tmp_path / "build")
    assert not list((tmp_path / "build").glob("*/*.so"))


# ---- layouts, rectification, ATE ------------------------------------------

def _layout(tmp_path, name):
    d = tmp_path / name
    if name == "tum":
        d.mkdir()
        (d / "rgb.txt").write_text("#\n")
    elif name == "tum_rgbd":
        d.mkdir()
        for f in ("rgb.txt", "depth.txt", "associations.txt"):
            (d / f).write_text("#\n")
    elif name == "kitti":
        (d / "image_0").mkdir(parents=True)
        (d / "image_1").mkdir()
    elif name == "euroc":
        (d / "mav0" / "cam0" / "data").mkdir(parents=True)
    else:
        d.mkdir()
    return str(d)


@pytest.mark.parametrize("name,sensor", [
    ("tum", "auto"), ("tum", "rgbd"), ("tum_rgbd", "auto"),
    ("tum_rgbd", "mono"), ("kitti", "auto"), ("kitti", "stereo"),
    ("euroc", "auto"), ("empty", "auto")])
def test_detect_agrees_with_jax(name, sensor, tmp_path):
    d = _layout(tmp_path, name)
    if name == "empty":
        for fn in (run_dataset.detect, jrun_dataset.detect):
            with pytest.raises(SystemExit):
                fn(d, sensor)
        return
    kind, driver, settings = run_dataset.detect(d, sensor)
    jkind, jdriver, jsettings = jrun_dataset.detect(d, sensor)
    assert (kind, settings) == (jkind, jsettings)
    assert jdriver == f"examples/{driver}.py"
    # The default settings file is the package's own copy of the JAX one,
    # as is the stereo node's rectification file (drivers/ros_stereo.py).
    for ours, theirs in ((settings, jsettings),
                         ("euroc_stereo.yaml", "euroc_stereo.yaml")):
        with open(os.path.join(run_dataset.SETTINGS, ours), "rb") as f, \
                open(os.path.join(SETTINGS, theirs), "rb") as g:
            assert f.read() == g.read()


def test_rectify_maps_bit_equal_to_jax(rng):
    """build_rectify_map / remap_bilinear on examples/settings/
    euroc_stereo.yaml, bit-equal to examples/stereo_euroc.py's."""
    path = os.path.join(SETTINGS, "euroc_stereo.yaml")
    cfg = load_settings(path, Sensor.STEREO)
    jcfg = jload_settings(path, JSensor.STEREO)
    W, H = cfg.camera.width, cfg.camera.height
    img = rng.uniform(0, 255, (H, W)).astype(np.float32)
    for blk, jblk in ((cfg.rect_left, jcfg.rect_left),
                      (cfg.rect_right, jcfg.rect_right)):
        for k in ("K", "D", "R", "P"):
            np.testing.assert_array_equal(blk[k], jblk[k])
        m = stereo_euroc.build_rectify_map(blk["K"], blk["D"], blk["R"],
                                           blk["P"], W, H)
        jm = jstereo_euroc.build_rectify_map(jblk["K"], jblk["D"], jblk["R"],
                                             jblk["P"], W, H)
        np.testing.assert_array_equal(m[0], jm[0])
        np.testing.assert_array_equal(m[1], jm[1])
        np.testing.assert_array_equal(stereo_euroc.remap_bilinear(img, *m),
                                      jstereo_euroc.remap_bilinear(img, *jm))


def _orbit(n):
    from orb_slam_system_tpu_torch.dataio.synthetic import orbit_trajectory
    return orbit_trajectory(n, radius=0.35, depth=-2.0, tilt=0.3)


def test_evaluate_ate_equals_tool(tmp_path, rng):
    """The port's evaluate_ate gives the tool's ATE (and RPE) to 1e-9 on a
    TUM pair of files, Sim3- and SE3-aligned."""
    poses = _orbit(20)
    gt, est = tmp_path / "gt.txt", tmp_path / "est.txt"
    gt.write_text("# gt\n" + "\n".join(
        layouts.tum_pose_line(i / 30.0, T) for i, T in enumerate(poses)))
    noisy = []
    for T in poses[1::2]:
        T = T.copy()
        T[:3, 3] = 0.5 * T[:3, 3] + rng.normal(0, 0.01, 3)
        noisy.append(T)
    est.write_text("\n".join(layouts.tum_pose_line((2 * i + 1) / 30.0 + 0.004, T)
                             for i, T in enumerate(noisy)))
    for scale in (True, False):
        stats = []
        for mod in (evaluate_ate, jevaluate_ate):
            g, e = mod.load_trajectory(str(gt)), mod.load_trajectory(str(est))
            pairs = mod.associate(g, e, 0.0, 0.02)
            s = mod.ate(g, e, pairs, scale)
            s.update(mod.rpe(g, e, pairs, 1))
            stats.append(s)
        assert stats[0]["compared_pose_pairs"] == 10
        for k, v in stats[1].items():
            assert abs(stats[0][k] - v) <= 1e-9, k
    assert evaluate_ate.main([str(gt), str(est), "--scale",
                              "--max_ate", "0.05"]) == 0


def test_euroc_flow_reads_cam0(tmp_path, have_native):
    """Fault 1: run_dataset hands the EuRoC driver <seq>/mav0/cam0, where
    data/<ns>.png lives (tools/run_dataset.py:108-109 hands it <seq>)."""
    seq = tmp_path / "MH01"
    ns = [1403636579763555584 + 50_000_000 * i for i in range(3)]
    frames = [np.full((8, 10), 40 * i, np.uint8) for i in range(3)]
    ts = layouts.write_euroc(str(seq), frames, ns, _orbit(3))
    args = run_dataset.parse_args([str(seq), "--timestamps", ts])
    kind, _, settings = run_dataset.detect(str(seq), "auto")
    argv = run_dataset.driver_argv(kind, args, settings)
    cam_dir = argv[2]
    assert cam_dir == os.path.join(str(seq), "mav0", "cam0")
    paths, _ = datasets.load_euroc(cam_dir, ts)
    assert all(os.path.exists(p) for p in paths)
    for i, p in enumerate(paths):
        assert float(datasets.load_image_gray(p)[0, 0]) == 40 * i
    jpaths, _ = jdatasets.load_euroc(str(seq), ts)   # the JAX flow's folder
    assert not any(os.path.exists(p) for p in jpaths)


def test_kitti_mono_keyframes_pair_with_ground_truth(tmp_path):
    """Fault 2: a monocular KITTI run writes KeyFrameTrajectory.txt in TUM
    format stamped with times.txt's seconds; the port's flow stamps the
    KITTI-format ground truth with the same file, so every keyframe pairs
    with its own pose (the JAX tool, stamping it 0, 1, 2, ..., pairs one)."""
    n, times = 30, [0.1037 * i for i in range(30)]
    poses = _orbit(n)
    seq = tmp_path / "00"
    gt = layouts.write_kitti(str(seq), [np.zeros((4, 4), np.uint8)] * n,
                             times, poses)
    kf_frames = [0, 3, 7, 12, 18, 25]
    traj = tmp_path / "KeyFrameTrajectory.txt"
    traj.write_text("\n".join(layouts.tum_pose_line(times[i], poses[i])
                              for i in kf_frames) + "\n")
    args = run_dataset.parse_args([str(seq), "--max-ate", "0.001"])
    argv = run_dataset.eval_argv("kitti_mono", args, gt, str(traj))
    assert "--gt_times" in argv
    g = evaluate_ate.load_trajectory(gt, evaluate_ate.load_times(
        str(seq / "times.txt")))
    e = evaluate_ate.load_trajectory(str(traj))
    pairs = evaluate_ate.associate(g, e, 0.0, 0.02)
    assert [tg for tg, _ in pairs] == [times[i] for i in kf_frames]
    assert evaluate_ate.main(argv) == 0          # exact poses: ATE ~0
    jg = jevaluate_ate.load_trajectory(gt)
    assert len(jevaluate_ate.associate(jg, e, 0.0, 0.02)) < len(kf_frames)
