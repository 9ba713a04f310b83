"""Build, load and count the port's hand-written CUDA kernels.

All sources in ``orb_slam_system_tpu_torch/csrc/*.cu`` compile with nvcc
into ONE shared library with a plain C interface, loaded through ctypes
(no PyTorch headers, so the build takes seconds). The build happens at
first use, into ``build/torch_kernels/<hash>/`` at the repository root,
keyed by a hash of the sources and flags; nothing is built at import time.

Each wrapper counts its launches in ``LAUNCHES`` (plain integers), so a run
can show that its main path really went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

# -fmad=false: no multiply-add contraction anywhere, so the blur in
# gather_blur_moments rounds exactly like the plain PyTorch version.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

LAUNCHES = {"fast_score_nms": 0, "gather_blur_moments": 0, "brief_pack": 0,
            "gather_patches": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every function returns cudaError_t).
_SIGNATURES = {
    "orb_fast_score_nms": [_VP, _VP, _I, _I, _I, _I, _VP],
    "orb_gather_blur_moments": [_VP, _VP, _VP, _VP, _VP, _VP,
                                _I, _I, _I, _I, _I, _VP],
    "orb_brief_pack": [_VP, _VP, _VP, _VP, _I, _VP],
    "orb_gather_patches": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
}

_lib = None
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed build directory (no-op when the
    library for these sources and flags exists). Returns its path. One nvcc
    per source, all started together, then one link."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "liborb_kernels.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [out_dir / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [subprocess.Popen(
        [nvcc_path(), *compile_flags, *(["-Xptxas", "-v"] if verbose else []),
         "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
    tmp = out_dir / f"liborb_kernels.{tag}.so"
    res = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                          *map(str, objs)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + res.stdout + res.stderr)
    if verbose:
        print("".join(logs) + res.stdout + res.stderr, flush=True)
    os.replace(tmp, lib_path)
    for o in objs:
        o.unlink(missing_ok=True)
    return lib_path


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.orb_cuda_error_string.argtypes = [ctypes.c_int]
            lib.orb_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call C entry point `name` on the current stream of the current
    device; raise if the launch reports an error, else count it."""
    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.orb_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc}: {msg}")
    LAUNCHES[counter] += 1


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """Wrapper-side argument check for a kernel input."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
