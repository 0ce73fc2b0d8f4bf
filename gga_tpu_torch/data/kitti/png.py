"""The port's own PNG reader and writer for KITTI's camera images (the
machine with the card has no Pillow; gga_tpu decodes with
``PIL.Image.open(path).convert('RGB')``,
``gga_tpu/data/kitti/mono_dataset.py:42-45``, and writes its synthetic
frames with ``PIL.Image.save``).

``read_png(path)`` returns the image as RGB ``uint8 [H, W, 3]``, the same
bytes as Pillow's: 8-bit samples, colour types 0 (grey, repeated into
R, G and B as ``convert('RGB')`` does), 2 (RGB) and 6 (RGBA, alpha
dropped), not interlaced. Anything else (palette, grey with alpha, 16-bit
samples, Adam7 interlacing, a bad CRC or filter byte) raises ValueError.

The image data is inflated with ``zlib``; the scanlines are unfiltered by
``csrc/png_unfilter.cpp``, built with ``g++`` at first use into
``build/`` beside this file (gitignored) and loaded with ``ctypes``. A
build failure raises. ``unfilter_numpy`` is the same unfiltering in numpy,
kept as the C++'s oracle: Sub is a cumsum mod 256 and Up a row add, but
Average and Paeth read the byte just reconstructed to their left, so they
loop along the row in Python (``chip_smoke.py`` times both readers on a
KITTI-sized frame).

``write_png(path, img)`` writes an RGB ``uint8 [H, W, 3]`` image as an
8-bit RGB PNG, not interlaced, whose row y is filtered with type y % 5
(None, Sub, Up, Average, Paeth; PNG spec section 9), so that a reader of
its files meets all five.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}        # colour type -> samples a pixel
_SRC = Path(__file__).resolve().parent / 'csrc' / 'png_unfilter.cpp'
_BUILD = Path(__file__).resolve().parent / 'build'
_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_lib = None
_lock = threading.Lock()


def _library():
    """The unfilter library, compiled once per source version: the file
    is named by a digest of the source and flags and written under a
    temporary name first, so processes building it at once never load half
    a file."""
    global _lib
    with _lock:
        if _lib is None:
            h = hashlib.sha256(_SRC.read_bytes())
            h.update('\0'.join(_FLAGS).encode())
            so = _BUILD / f'libpng_unfilter_{h.hexdigest()[:12]}.so'
            if not so.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f'.{os.getpid()}.tmp')
                proc = subprocess.run(
                    ['g++', *_FLAGS, '-o', str(tmp), str(_SRC)],
                    capture_output=True, text=True, timeout=300)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f'g++ failed on {_SRC.name} ({proc.returncode}):\n'
                        f'{proc.stdout}{proc.stderr}')
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int]
            lib.png_unfilter.restype = ctypes.c_int
            _lib = lib
        return _lib


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_numpy(raw, height, width, bpp):
    """Reconstructed scanlines [height, width * bpp] uint8 from the
    inflated data (one filter byte, then the filtered row)."""
    stride = width * bpp
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(width, bpp), axis=0).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = line.copy()
            for i in range(0, stride, bpp):
                left = cur[i - bpp:i] % 256 if i else np.zeros(bpp, np.int64)
                up = prev[i:i + bpp]
                if kind == 3:
                    cur[i:i + bpp] += (left + up) >> 1
                else:
                    up_left = prev[i - bpp:i] if i else np.zeros(bpp,
                                                                  np.int64)
                    cur[i:i + bpp] += _paeth(left, up, up_left)
        else:
            raise ValueError(f'PNG row {y}: unknown filter type {kind}')
        prev = cur % 256
        out[y] = prev
    return out


def unfilter(raw, height, width, bpp):
    """``unfilter_numpy`` in C++ (``csrc/png_unfilter.cpp``)."""
    stride = width * bpp
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    bad = _library().png_unfilter(src.ctypes.data, out.ctypes.data, height,
                                  stride, bpp)
    if bad:
        raise ValueError(f'PNG row {bad - 1}: unknown filter type '
                         f'{src[(bad - 1) * (stride + 1)]}')
    return out


def decode_png(data, unfilter_fn=unfilter):
    """PNG bytes -> RGB uint8 [H, W, 3] (see the module docstring)."""
    if data[:8] != SIGNATURE:
        raise ValueError('not a PNG file')
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError('PNG ends before its IEND chunk')
        length, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f'PNG chunk {kind!r} is cut off')
        if struct.unpack('>I', crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f'PNG chunk {kind!r} fails its CRC')
        pos += 12 + length
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
        elif kind == b'IEND':
            break
    if header is None:
        raise ValueError('PNG has no IHDR chunk')
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f'unsupported PNG: bit depth {depth}, colour type '
                         f'{colour} (8-bit grey, RGB or RGBA only)')
    if compression or filtering or interlace:
        raise ValueError(f'unsupported PNG: compression {compression}, '
                         f'filter method {filtering}, interlace {interlace}')
    bpp = _CHANNELS[colour]
    raw = zlib.decompress(b''.join(idat))
    if len(raw) < height * (width * bpp + 1):
        raise ValueError(f'PNG image data holds {len(raw)} bytes, '
                         f'{height} x {width} needs '
                         f'{height * (width * bpp + 1)}')
    img = unfilter_fn(raw, height, width, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def read_png(path):
    """The PNG file at ``path`` as RGB uint8 [H, W, 3]."""
    with open(path, 'rb') as f:
        return decode_png(f.read())


def _chunk(kind, data):
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))


def write_png(path, img):
    """Write ``img`` (RGB uint8 [H, W, 3]) to ``path`` as a PNG (see the
    module docstring)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'write_png takes RGB uint8 [H, W, 3], not '
                         f'{img.dtype} {img.shape}')
    h, w, c = img.shape
    prev, rows = np.zeros(w * c, np.int64), []
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = left + prev - up_left
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
        pred = (0, left, prev, (left + prev) // 2,
                np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, up_left)))[y % 5]
        rows.append(bytes([y % 5])
                    + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    with open(path, 'wb') as f:
        f.write(SIGNATURE
                + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b'IDAT', zlib.compress(b''.join(rows)))
                + _chunk(b'IEND', b''))
