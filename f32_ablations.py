#!/usr/bin/env python3
"""Ablations of the f32 sparse-conv kernels on one NVIDIA card.

    python3 f32_ablations.py     # from the repository root; needs one card

Builds variants of gga_tpu_torch/kernels/csrc/gather_gemm.cu and
gather_gemm_dw.cu, each a text edit of the sources compiled by nvcc into a
temporary directory, records the sparse-conv calls of one full-width f32
forward at chip_smoke.py's bench point, and times each variant's C entries
(gga_gather_gemm_conv_f32, gga_gather_gemm_dw_f32 with a seeded dout) at
every (K, C, D) of that forward with CUDA events around 20 calls, beside
its error against the plain version. The variants:

  design       the sources as they are
  rna_lo       lo rounded to TF32 (cvt.rna) instead of read truncated
  no_guard     the split without its non-finite guard (wrong on inf, NaN)
  one_tf32     hi * hi alone: one TF32 product, not f32-accurate
  no_mma       the operands loaded and split, no MMA (timing only)
  no_products  no fragment loads or MMAs: the pipeline alone (timing only)
  tc_narrow    C and D <= 32 on the 3xTF32 designs instead of FFMA

Prints the card's name and power limit, then one line per (K, C, D) and
kernel: ms per call of each variant and its max|error| / max|plain|; the
same goes to chiprun_out/f32_ablations.json. Exits non-zero without a card.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import chip_smoke as cs

CSRC = cs.ROOT / 'gga_tpu_torch' / 'kernels' / 'csrc'
HEADER = 'gather_tile.cuh'
SOURCES = ('gather_gemm', 'gather_gemm_dw')

SPLIT = """  s.lo = finite ? __float_as_uint(x - hf) : 0u;"""
MMA3 = """  mma_1688(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hx, b[1].hx);
  mma_1688(d, a[0].hx, a[1].hx, a[2].hx, a[3].hx, b[0].lo, b[1].lo);
  mma_1688(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);"""
GUARD = """  const bool finite = fabsf(hf) < __int_as_float(0x7f800000);"""
# (file, old, new) text edits of each variant
VARIANTS = {
    'design': [],
    'rna_lo': [(HEADER, SPLIT, """  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x - hf));
  s.lo = finite ? r : 0u;""")],
    'no_guard': [(HEADER, GUARD, """  const bool finite = true;""")],
    'one_tf32': [(HEADER, MMA3, """  mma_1688(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);""")],
    'no_mma': [(HEADER, MMA3, """  d[0] += __uint_as_float(a[0].lo ^ a[3].hx ^ b[0].hi ^ b[1].lo);""")],
    'no_products': [
        ('gather_gemm.cu', """    if (hit == 0) continue;""", """    continue;"""),
        ('gather_gemm_dw.cu', """        if (hits == 0) continue;""",
         """        continue;""")],
    'tc_narrow': [
        ('gather_gemm.cu', """  if (C <= 32 && D <= 32) {""", """  if (false) {"""),
        ('gather_gemm_dw.cu', """  return C <= 32 && D <= 32 ? ffma_plan""",
         """  return false ? ffma_plan"""),
        ('gather_gemm_dw.cu', """  if constexpr (CS <= 32) {  // C and D <= 32 take the FFMA path""",
         """  if constexpr (false) {""")],
}
P, I = ctypes.c_void_p, ctypes.c_int


def build(tmp, name, edits):
    """Start the nvcc runs of one variant: {source: (Popen, .so path)}."""
    d = Path(tmp) / name
    d.mkdir()
    texts = {f: (CSRC / f).read_text()
             for f in (HEADER,) + tuple(f'{s}.cu' for s in SOURCES)}
    for f, old, new in edits:
        if old not in texts[f]:
            cs.fail(f'variant {name}: the text to edit is not in {f}')
        texts[f] = texts[f].replace(old, new)
    for f, text in texts.items():
        (d / f).write_text(text)
    nvcc = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    from gga_tpu_torch.kernels import _build
    jobs = {}
    for s in SOURCES:
        so = d / f'lib{s}.so'
        jobs[s] = (subprocess.Popen(
            [nvcc, *_build.FLAGS, '-o', str(so), str(d / f'{s}.cu')],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    return jobs


def main():
    import torch
    if not torch.cuda.is_available():
        cs.fail('torch.cuda.is_available() is False')
    sys.path.insert(0, str(cs.ROOT))
    from gga_tpu_torch import apis
    from gga_tpu_torch.kernels import sparse_conv
    card = cs.card_line()
    print(f'card: {card}')
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {v: build(tmp, v, e) for v, e in VARIANTS.items()}
        libs = {}
        for v, srcs in jobs.items():
            for s, (proc, so) in srcs.items():
                out, _ = proc.communicate()
                if proc.returncode:
                    cs.fail(f'variant {v}: nvcc failed on {s}.cu:\n{out}')
                libs[v, s] = ctypes.CDLL(str(so))

        cfg, _ = cs.configs('float32')
        bundle = apis.init_detector(cfg, device=cs.DEVICE, seed=0)
        dev = bundle.device
        with cs.recording(sparse_conv, 'gather_gemm_conv') as calls:
            with torch.no_grad():
                bundle.model(*cs.scene_points(torch, dev, 0))
        shapes = {}
        for _, (f, nmap, w) in calls:
            shapes.setdefault(tuple(w.shape), (f, nmap, w))
        g = torch.Generator(device=dev).manual_seed(0)
        results = []
        with torch.no_grad():
            for (K, C, D), (f, nmap, w) in shapes.items():
                Q = nmap.shape[1]
                dout = torch.randn(Q, D, device=dev, generator=g)
                refs = dict(
                    conv=sparse_conv.gather_gemm_conv_plain(f, nmap, w),
                    dw=sparse_conv.gather_gemm_dw_plain(f, nmap, dout))
                for kernel, ref in refs.items():
                    row = dict(K=K, C=C, D=D, kernel=kernel)
                    for v in VARIANTS:
                        row[v] = run_variant(torch, libs, v, kernel, f, nmap,
                                             w, dout, ref)
                    results.append(row)
                    print(f'{kernel:4s} {K:>2} {C:>3} {D:>3}: ' + ', '.join(
                        f'{v} {row[v][0]:.4f} ({row[v][1]:.1e})'
                        for v in VARIANTS), flush=True)
    out_dir = cs.ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / 'f32_ablations.json', 'w') as fh:
        json.dump(dict(card=card, rows=results), fh, indent=1)


def run_variant(torch, libs, v, kernel, f, nmap, w, dout, ref):
    """(ms per call, max|error| / max|plain|) of one variant's entry."""
    K, C, D = w.shape
    R, Q = f.shape[0], nmap.shape[1]
    stream = P(torch.cuda.current_stream().cuda_stream)
    if kernel == 'conv':
        lib = libs[v, 'gather_gemm']
        out = torch.empty(Q, D, device=f.device)

        def fn():
            return lib.gga_gather_gemm_conv_f32(
                P(f.data_ptr()), P(nmap.data_ptr()), P(w.data_ptr()),
                P(out.data_ptr()), I(R), I(C), I(K), I(Q), I(D), stream)
    else:
        lib = libs[v, 'gather_gemm_dw']
        splits = lib.gga_gather_gemm_dw_splits_f32(I(K), I(C), I(D), I(Q))
        part = torch.empty(splits, K, C, D, device=f.device)
        out = torch.empty(K, C, D, device=f.device)

        def fn():
            return lib.gga_gather_gemm_dw_f32(
                P(f.data_ptr()), P(nmap.data_ptr()), P(dout.data_ptr()),
                P(part.data_ptr()), P(out.data_ptr()), I(R), I(C), I(K),
                I(Q), I(D), I(splits), stream)
    if fn() != 0:
        cs.fail(f'variant {v}: the {kernel} launch failed at {(K, C, D)}')
    ms = cs.event_ms(torch, fn, 20)
    err = float((out - ref).abs().max() / ref.abs().max())
    return ms, err


if __name__ == '__main__':
    main()
