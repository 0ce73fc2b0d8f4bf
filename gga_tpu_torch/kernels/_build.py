"""Build and load the port's CUDA kernels: one ``nvcc`` per source into a
shared library with a plain C interface, loaded with ``ctypes``.

Each source under ``csrc/`` is compiled at first use for ``sm_90a`` into
``build/`` beside this file (gitignored). The library is named by the
source's digest, so an edited source rebuilds and an unchanged one loads
the library already there. ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them, so a fresh checkout builds in the time of
the slowest source.

Every C entry returns the ``cudaError_t`` of its launch; pointers and the
stream pass as ``c_void_p`` (a plain int would be cut to 32 bits).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD = Path(__file__).resolve().parent / 'build'
# the most dynamic shared memory one block may use on an H100
MAX_SMEM = 232448

P = ctypes.c_void_p
I = ctypes.c_int

_libs = {}
_lock = threading.Lock()


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the port\'s CUDA kernels need '
                           'the CUDA toolkit to build')
    return path


def _so_path(name):
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, BUILD / f'lib{name}_{digest}.so'


def _start(name):
    """Popen of the nvcc that builds ``name`` (None if already built)."""
    src, so = _so_path(name)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
           '-O3', '-shared', '-Xcompiler', '-fPIC', '-o', str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, so


def _finish(name, job):
    if job is None:
        return
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on csrc/{name}.cu '
                           f'({proc.returncode}):\n{out}')
    os.replace(tmp, so)


def build_all(names):
    """Compile every named source that is not built yet, all nvcc runs at
    once. Returns {name: seconds until its library was ready}."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    seconds = {}
    for n, job in jobs.items():
        _finish(n, job)
        seconds[n] = time.perf_counter() - t0
    return seconds


def load(name, signatures):
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    signatures: {C function name: (argtypes, restype)}."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_so_path(name)[1]))
            for fn, (args, res) in signatures.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return lib


def stream_of(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(what, err):
    if err != 0:
        raise RuntimeError(f'{what}: kernel launch failed with CUDA error '
                           f'{err}')


def check_cuda(what, tensors, aligned=()):
    """Every tensor on the first one's CUDA device, contiguous, and no
    dimension product past int32; those named in ``aligned`` (read with
    16-byte loads) 16-byte aligned."""
    dev = tensors[0][1].device
    for name, t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f'{what}: {name} must lie on the same CUDA '
                             'device as the other inputs')
        if not t.is_contiguous():
            raise ValueError(f'{what}: {name} must be contiguous')
        if name in aligned and t.data_ptr() % 16:
            raise ValueError(f'{what}: {name} must be 16-byte aligned')
        if t.numel() >= 2 ** 31:
            raise ValueError(f'{what}: {name} has more elements than the '
                             'kernel\'s int32 sizes hold')
