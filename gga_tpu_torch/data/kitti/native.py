"""ctypes bridge to the native (C++) weak-label kernels (the port's copy
of ``gga_tpu/data/kitti/native.py``).

Loads native/libgga_native.so, the repository's host C++ region grow,
building it with ``make -C native`` on first use when it is missing;
callers use the numpy implementation when it cannot be built (both give
the same results, ``tests/test_data/test_region_grow_equivalence.py``).
This is host code: nothing here runs on the card.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    root = os.path.normpath(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), '..', '..', '..',
        'native'))
    path = os.path.join(root, 'libgga_native.so')
    if not os.path.exists(path):
        # lazy one-shot build (~1 s); silently fall back on failure
        import subprocess
        try:
            subprocess.run(['make', '-C', root], capture_output=True,
                           timeout=120, check=True)
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    lib.region_grow.restype = ctypes.c_int
    lib.region_grow.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return _LIB


def available():
    return _load() is not None


def region_grow_native(pc, mask_search, mask_origin, thresh, ratio=0.8):
    """Native region_grow; same contract as gga_labels.region_grow.
    Returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pc = np.ascontiguousarray(pc[:, :3], np.float32)
    ms = np.ascontiguousarray(mask_search, np.uint8)
    mo = np.ascontiguousarray(mask_origin, np.uint8)
    out = np.zeros(pc.shape[0], np.uint8)
    lib.region_grow(
        pc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pc.shape[0],
        ms.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        mo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_float(thresh),
        ctypes.c_float(ratio if ratio is not None else 0.0),
        ctypes.c_int(1 if ratio is not None else 0),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(np.float64)
