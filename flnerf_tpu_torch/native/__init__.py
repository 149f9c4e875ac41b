"""ctypes bindings for the native host sampler (``sampler.cpp``).

Port of ``flnerf_tpu/native/__init__.py``; ``sampler.cpp`` is a copy of
the reference package's source.  The library is built with g++ on first
use into ``build/native/`` at the repository root and loaded with ctypes.
Without a host compiler the callers fall back to their numpy paths, as in
the reference package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sampler.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_SO = os.path.join(_BUILD, "libflnerf_sampler.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # build to a private name, then rename: test workers may race here
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, _SO)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sample_leaves_weighted.restype = ctypes.c_int64
    lib.sample_leaves_weighted.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        i64p, ctypes.c_int64, ctypes.c_uint64, i64p, i64p,
    ]
    _LIB = lib
    return _LIB


def sample_leaves_weighted(sharp, boxes, img, counts, seed: int):
    """Native weighted per-leaf sampling; returns (px, py) or None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    sharp = np.ascontiguousarray(sharp, np.float32)
    boxes = np.ascontiguousarray(boxes, np.float64)
    img = np.ascontiguousarray(img, np.int32)
    counts = np.ascontiguousarray(counts, np.int64)
    total = int(counts.sum())
    px = np.empty(total, np.int64)
    py = np.empty(total, np.int64)
    n_images, H, W = sharp.shape
    written = lib.sample_leaves_weighted(
        sharp.reshape(-1), n_images, H, W, boxes.reshape(-1), img,
        counts, counts.shape[0], seed & 0xFFFFFFFFFFFFFFFF, px, py,
    )
    if written != total:
        return None
    return px, py
