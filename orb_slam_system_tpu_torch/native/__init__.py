"""ctypes bindings for the native C++ image decoder and prefetch ring.

Port of orb_slam_system_tpu/native/__init__.py. ``dataloader.cpp`` (a
copy of the JAX package's) decodes PNG (8/16-bit gray, RGB, RGBA, through
zlib) and PGM/PPM into f32 grayscale, one-shot (``decode_gray``) or ahead
of the consumer on C++ threads (``PrefetchLoader``). ctypes releases the
interpreter lock for each call, so a decode never holds tracking back.

It is built with g++ at first use into ``build/torch_native/<hash>/`` at
the repository root, keyed by a hash of the source and flags; nothing is
built at import time. Concurrent builders (test workers) each compile to
a file of their own and rename it into place, so none loads a half-written
library. Departures from the JAX bindings (orb_slam_system_tpu/native/
__init__.py:26-37, 84-119): a failed build raises with g++'s output, and a
failed decode raises naming the file, where the JAX package returns None
and its callers decode another way in silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List

import numpy as np

_DIR = Path(__file__).resolve().parent
SRC = _DIR / "dataloader.cpp"
BUILD_ROOT = _DIR.parent.parent / "build" / "torch_native"
# Portable baseline flags (no -march=native): a tuned library can outlive
# the machine it was built on; the decoder is bound by IO and zlib.
# libz.so.1 by name: the runtime library is there even where the
# development symlink libz.so is not.
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LINK_FLAGS = ["-l:libz.so.1", "-lpthread"]
MAX_PIXELS = 4096 * 4096

_lock = threading.Lock()
_lib = None


def build(src: Path = SRC, build_root: Path = BUILD_ROOT) -> Path:
    """Compile `src` into build_root/<hash>/libslamdata.so unless it is
    there. Returns its path; raises RuntimeError with g++'s output when the
    compiler is missing or fails."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + LINK_FLAGS).encode())
    h.update(src.read_bytes())
    out_dir = build_root / h.hexdigest()[:16]
    lib_path = out_dir / "libslamdata.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libslamdata.{os.getpid()}.{threading.get_ident()}.so"
    cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp), *LINK_FLAGS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native decoder failed: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native decoder failed "
                           f"({' '.join(cmd)}):\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded decoder library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            f32p, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
            lib.sd_create.restype = ctypes.c_void_p
            lib.sd_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.sd_get.restype = ctypes.c_int
            lib.sd_get.argtypes = [ctypes.c_void_p, ctypes.c_long, f32p,
                                   ctypes.c_long, ip, ip]
            lib.sd_destroy.restype = None
            lib.sd_destroy.argtypes = [ctypes.c_void_p]
            lib.sd_decode.restype = ctypes.c_int
            lib.sd_decode.argtypes = [ctypes.c_char_p, ctypes.c_int, f32p,
                                      ctypes.c_long, ip, ip]
            _lib = lib
    return _lib


def _call(fn, *args) -> np.ndarray:
    """Run a decode entry point into a MAX_PIXELS buffer; None on a
    nonzero return code, else the f32[H,W] image."""
    buf = np.empty(MAX_PIXELS, np.float32)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = fn(*args, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            MAX_PIXELS, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def decode_gray(path: str, raw16: bool = False) -> np.ndarray:
    """One-shot decode of a PNG / PGM / PPM to f32[H,W] gray in [0, 255];
    raw16 keeps 16-bit samples raw (depth maps). Raises on failure."""
    lib = library()
    out = _call(lib.sd_decode, os.fsencode(path), int(raw16))
    if out is None:
        raise RuntimeError(f"native decode failed: {path}")
    return out


class PrefetchLoader:
    """Threaded native prefetcher over an ordered path list: fetch(i)
    returns frame i, decoded ahead on up to four C++ threads with `depth`
    frames buffered. Use as a context manager, or call close()."""

    def __init__(self, paths: List[str], depth: int = 8, raw16: bool = False):
        self._lib = library()
        self.paths = list(paths)
        self._keepalive = (ctypes.c_char_p * len(self.paths))(
            *[os.fsencode(p) for p in self.paths])
        self._handle = self._lib.sd_create(self._keepalive, len(self.paths),
                                           depth, int(raw16))

    def fetch(self, idx: int) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("PrefetchLoader is closed")
        if not 0 <= idx < len(self.paths):
            raise IndexError(f"frame {idx} of {len(self.paths)}")
        out = _call(self._lib.sd_get, self._handle, idx)
        if out is None:
            raise RuntimeError(f"native decode failed: {self.paths[idx]}")
        return out

    def close(self):
        if self._handle is not None:
            self._lib.sd_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass
