#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-3 inference and GGA weak training
paths, the GGA workflow's command-line tools, the stage-4 PGD retrain and
the indoor FCAF3D retrain on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds the four CUDA sources of gga_tpu_torch/kernels/csrc/ (one nvcc
   each for sm_90a, all started at once) and prints each build time.
3. Inference kernel phase: one full-width forward (GGAModelConfig(), bf16,
   B=8 scenes of P=20 000 points, seeded random weights) records the inputs
   of all 21 sparse conv calls; each is replayed through gather_gemm_conv
   and its plain version, |kernel - plain| <= 1e-2 * max|plain| + one bf16
   ulp, and both are timed with CUDA events beside the card's bound (the
   bytes count each distinct source row the call's map hits once); one row
   per (K, C, D) with its share of the bound (bound_ms / ms).
4. Stage-3 phase: ``apis.infer`` on distinct batches after a warm-up, with
   the launch count read around the run (exactly 21 per forward), scenes/s,
   a per-stage breakdown, a torch.profiler view, and the BEV map and head
   logits held against the same forward with the plain conv.
5. Train phase: ``apis.init_trainer`` at bench.py's operating point (the
   same config with GGAHeadConfig(max_objs=500), B=8, P=20 000, M=500
   objects, Pc=256 cluster points, build_optimizer(total_steps=10000)).
   One warm-up step records every call of the path's kernels; then the
   counts are set to 0 and 5 timed steps on distinct batches must launch
   exactly 37 gather_gemm_conv (21 forward + 16 submanifold input
   gradients), 21 gather_gemm_dw, 4 gather_rows and 1 render_heatmap per
   step, with finite losses and grad norms, moved parameters and moved
   batch-norm statistics. Prints scenes/s, a per-stage breakdown and a
   profile of one step.
6. Train kernel phase: every recorded call is replayed through its kernel
   and plain version (gather_gemm_dw |kernel - plain| <= 1e-4 max|plain|,
   and a second kernel call on the same inputs gives the same bits;
   gather_rows and gather_rows_t, the latter on the step's strided maps,
   exactly; render_heatmap |kernel - plain| <= 1e-6 with the same pixels
   at 1.0; the 16 input-gradient convs at the bf16 tolerance of 3.) and
   timed beside the bound (per (K, C, D) with its share for the two
   sparse-conv kernels) and, for gather_rows, index_select.
   Every replayed call (here and in 3.) is timed twice: by CUDA events
   around 20 back-to-back wrapper calls (``ms``; a call shorter than the
   host's work per call reads the host's issue rate), and by the device's
   own clock, the same 20 calls under torch.profiler (``device_ms``: the
   self device time of the wrapper's kernels, found by name, per call;
   "not measured" where the profiler saw none). For render_heatmap and
   gather_rows_t it also prints the wrapper's host cost per call
   (``host_ms``: a host clock around 100 calls, read before the
   synchronize that follows them).
7. Whole step, kernels vs plain: one step's loss and gradients with every
   kernel and with every plain version, from the same weights, batch and
   SRL draw: loss within 1e-2 relative, grad norm within 5e-2 relative,
   each sparse conv weight gradient at cosine similarity >= 0.99 or, where
   the plain step with a one-ulp perturbation of the encoder input already
   moves that gradient further (the bf16 step is that sensitive at this
   operating point), within twice that distance and never below 0.97;
   each batch-norm statistics update within 1e-2 of its largest entry.
   The plain step's one-ulp grad-norm change is printed beside.
8. f32 phase: steps 3-7 for the sparse-conv kernels in f32 (the shipped
   configs' dtype; the f32 entries of gather_gemm_conv and gather_gemm_dw,
   3xTF32 on the tensor cores): one forward's 21 and one train step's 37
   + 21 calls replayed against their plain f32 versions (TF32 off; conv
   within 1e-5, dW within 2e-5 of max|plain| per call, both the same
   bits on a second call) and timed beside the f32 bound (3xTF32,
   164.9 TFLOP/s, bytes of 4-byte elements), with the share of the FFMA
   bound (67 TFLOP/s) beside it and, per (K, C, D), the rows the kernel
   multiplies over the hit rows (from the map and the kernel's row
   groups); f32 stage-3 and train scenes/s with exact launch counts;
   the forward with kernels within 1e-4 of max|plain|; one whole step
   with kernels vs plain: loss within 1e-4 relative, grad norm within
   1e-3, each weight gradient at cosine >= 0.9999, or >= 0.999 within
   twice the plain step's one-f32-ulp distance, batch-norm updates within
   1e-3.
9. Workflow phase: stages 1-3 of the GGA workflow and the stage-4 export
   through the port's command-line tools (``main(argv)``, in-process) on
   a KITTI-format mini dataset written to a temporary dir (16 scenes, 8
   train + 8 val, of 120 000 lidar points with about 20 000 in the
   camera's view, 8-16 Car / Pedestrian / Cyclist boxes ahead of the
   camera, 375 x 1242 RGB PNGs rendered from the points with all five
   PNG row filters), the shipped configs as shipped (f32):
   ``create_data_gga``; ``train`` on configs/gga/gga_kitti.py at B = 8
   for 4 steps (2 an epoch, a checkpoint each epoch), then ``--resume``
   to step 6; ``generate_pseudo_labels_gga`` on
   configs/gga/gga_kitti_matching.py with ``--eval``; ``test`` with
   ``--eval --format-only`` on the 8 val scenes and with ``--aug-test``
   on 2 of them (6 variants a scene); ``create_data_gga_retrain_mono`` on
   the pseudo pkl, its json's image and annotation counts held against
   the infos. The counts are set to 0 before each tool and read after
   it: 37 / 21 / 4 / 1 launches per train step and 21 gather_gemm_conv
   per stage-3 batch and per TTA variant, nothing else.
   Fails unless every logged loss is finite, the resume
   starts at step 4, each step ran at the lr cyclic_cos_schedule gives
   for its count, the pseudo pkl holds 16 infos, and the stage-3 tool's
   first batch of detections (every candidate slot, kept or not) equals
   ``apis.infer`` on the same padded batch with the weights of the same
   checkpoint. Prints stage-1 seconds
   and which region grow ran, train scenes/s after the first step (loader
   included) with the loader's share, the checkpoints' size and save /
   load ms, and stage-3 scenes/s (load through matching), each beside the
   card's name and power limit.
10. Stage-4 phase, on the same mini KITTI: the port's PNG reader timed
    on one frame (host; C++ unfilter and its numpy oracle, the same
    bytes); ``train_pgd`` on configs/gga/gga_pdg.py as shipped (ResNet-101
    + FPN + PGDHead, f32, B = 12) over a pseudo-format pkl of the 16 scenes
    with their ground truth: 3 steps (one an epoch, a checkpoint at each
    epoch's end), then ``--resume`` to step 4. None of the port's kernels
    may launch (the counts are set to 0 before each run and read after).
    Fails unless every logged loss is finite with num_pos > 0, each step
    ran at the lr step_schedule gives for its count, the resume ran step
    4, every parameter and BN statistic moved from the seeded weights, the
    head outputs and decode of 4 images from step_4.pt equal the
    in-memory weights', and
    ``tools_lib.evaluate_mono`` returns its five AP keys. Prints, beside
    the card's name and power limit, train images/s after the first step
    with the loader (and its wait share) and by CUDA events around the
    steps, the train runs' peak ``max_memory_allocated``, the checkpoint's
    MiB and save / load ms, and inference images/s.
11. Indoor phase (``indoor_phase``), the indoor GGA retrain: a mini
    SUN RGB-D written from seed 0 (16 scenes of 50 000 xyzrgb points: a
    floor, two walls and 4-8 upright boxes of the 10 classes) and
    configs/gga/gga_sunrgbd.py as shipped (FCAF3D: MinkResNet34 + head,
    f32, B = 2 x 20 000 points, voxel 0.01 m). One recorded train step's
    79 gather_gemm_conv and 40 gather_gemm_dw calls are replayed
    against their plain versions within the f32 gates and timed per
    (K, C, D); one eval-mode forward with the kernels against the plain
    versions (each backbone level within 1e-4 of max|plain|, each head
    level the same kept sites after its prune, then its outputs within
    1e-4); then ``train_fcaf3d`` for 4 steps and ``--resume`` to 6 with
    exact launch counts (79 / 40 a step, nothing else), CUDA events
    around the steps, active sites against every budget, finite losses
    with positives, each step's lr, every parameter and BN statistic
    moved, the head outputs and decode from step_6.pt equal to the
    in-memory weights' bit for bit (NaNs in the same places: six steps
    from random weights overflow the eval-mode head's exp());
    ``infer_indoor`` + ``indoor_eval`` on 8 scenes
    (40 launches a forward) with the mAP keys. Prints scenes/s (events
    and with the loader), peak memory, checkpoint MiB and ms, and
    inference scenes/s, each beside the card's name and power limit.
12. Prints one JSON line describing the kernels (each with its time
    ms, device_ms, launches, bound and bound_share = bound_ms / ms,
    device_bound_share = bound_ms / device_ms, host_ms where measured;
    the f32 entries as gather_gemm_conv_f32 and gather_gemm_dw_f32, with
    ffma_bound_ms, their bound at the FFMA rate of 67 TFLOP/s, and an
    ``indoor`` dict with the same numbers over FCAF3D's recorded step),
    the card, then, as the last line, {"ok": true, "device": {...}}. Any
    failed phase exits non-zero.

Everything it measures is also written to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B, P = 8, 20000           # bench operating point: scenes x points per scene
M_OBJ, PC = 500, 256      # padded objects per scene, cluster points per object
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM
# f32-accurate products on the tensor cores: 3xTF32, three dense TF32
# products (494.7 TFLOP/s, H100 SXM) for each; the f32 sparse-conv bound
TF32X3_FLOPS = 494.7e12 / 3

SOURCES = ('gather_gemm', 'gather_gemm_dw', 'gather_rows', 'heatmap')
# device kernels each wrapper launches, by name, for the profiler's times
# (the sparse-conv wrappers launch the *_f32 kernels on f32 tensors)
KERNEL_NAMES = dict(gather_gemm_conv=('conv_narrow', 'conv_tile'),
                    gather_gemm_dw=('dw_kernel', 'dw_narrow', 'reduce_splits'),
                    gather_gemm_conv_f32=('conv_tf32', 'conv_ffma'),
                    gather_gemm_dw_f32=('dw_tf32', 'dw_ffma', 'reduce_splits'),
                    gather_rows=('gather_rows_kernel',),
                    gather_rows_t=('gather_rows_t_kernel',),
                    render_heatmap=('heatmap_kernel',))
TRAIN_STEPS = 5
# gates of each dtype: gather_gemm_conv and gather_gemm_dw vs plain, of
# max|plain| per call (bf16 conv: 1e-2 of max|plain| plus one bf16 ulp);
# the forward with kernels vs plain, of max|plain| (bf16: as the conv);
# whole step: loss and grad norm relative, each sparse conv weight
# gradient's cosine (cos_min, or cos_floor within twice the plain step's
# one-ulp distance), batch-norm updates of their largest entry
GATES = dict(
    bfloat16=dict(conv=None, dw=1e-4, forward=None, loss=1e-2, norm=5e-2,
                  cos_min=0.99, cos_floor=0.97, bn=1e-2),
    float32=dict(conv=1e-5, dw=2e-5, forward=1e-4, loss=1e-4, norm=1e-3,
                 cos_min=0.9999, cos_floor=0.999, bn=1e-3))
# sparse convs of one full-width forward: 17 submanifold (conv_input + 8
# basic blocks x 2) + 3 strided + conv_out; all but conv_input (whose
# input is the VFE output) take an input gradient
N_CONVS, N_DGRAD, N_STRIDED = 21, 16, 4
# launches per train step
PER_STEP = dict(gather_gemm_conv=N_CONVS + N_DGRAD, gather_gemm_dw=N_CONVS,
                gather_rows=N_STRIDED, render_heatmap=1)
DEVICE = 'cuda'


def f32_row_group(kernel, C, D):
    """Rows an f32 kernel multiplies together at a live offset, for every
    group of them that the offset hits at least once (gather_gemm.cu,
    gather_gemm_dw.cu "f32 path"): C and D <= 32 take the FFMA designs,
    whose conv tiles are 256 rows (D <= 16) or 128 and whose dW tiles
    32; the 3xTF32 designs skip 16-row MMA groups (conv) and 8-row
    k-steps (dW)."""
    if C <= 32 and D <= 32:
        return (256 if D <= 16 else 128) if kernel == 'conv' else 32
    return 16 if kernel == 'conv' else 8


def configs(dtype='bfloat16'):
    """(stage-3 config, train config): bench.py's operating point in
    ``dtype``."""
    from gga_tpu_torch.models.dense_heads.centerpoint_head_gga import \
        GGAHeadConfig
    from gga_tpu_torch.models.detectors.centerpoint_gga import GGAModelConfig
    return (GGAModelConfig(compute_dtype=dtype),
            GGAModelConfig(compute_dtype=dtype,
                           head=GGAHeadConfig(max_objs=M_OBJ)))


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def make_batch(batch, points, m, pc, seed=0):
    """KITTI-like synthetic scenes and weak labels (a copy of bench.py's
    make_batch)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 70.4, (batch, points, 1))
    y = (rng.uniform(-0.45, 0.45, (batch, points, 1)) * (x + 8))
    z = rng.uniform(-2.5, 0.5, (batch, points, 1))
    r = rng.rand(batch, points, 1)
    pts = np.concatenate([x, y, z, r], -1).astype(np.float32)
    valid = np.ones((batch, points), bool)

    n_obj = 24
    labels = np.full((batch, m), -1, np.int32)
    labels[:, :n_obj] = rng.randint(0, 3, (batch, n_obj))
    obj_valid = np.zeros((batch, m), bool)
    obj_valid[:, :n_obj] = True
    pseudo = np.zeros((batch, m, 7), np.float32)
    pseudo[:, :n_obj, 0] = rng.uniform(5, 65, (batch, n_obj))
    pseudo[:, :n_obj, 1] = rng.uniform(-35, 35, (batch, n_obj))
    pseudo[:, :n_obj, 2] = -1.0
    pseudo[:, :n_obj, 3:5] = rng.uniform(0.5, 4.5, (batch, n_obj, 2))
    pseudo[:, :n_obj, 5] = rng.uniform(1.2, 2.0, (batch, n_obj))
    boxes_img = np.zeros((batch, m, 4), np.float32)
    boxes_img[:, :n_obj, 0] = rng.uniform(0, 600, (batch, n_obj))
    boxes_img[:, :n_obj, 1] = rng.uniform(100, 250, (batch, n_obj))
    boxes_img[:, :n_obj, 2] = boxes_img[:, :n_obj, 0] + rng.uniform(
        30, 400, (batch, n_obj))
    boxes_img[:, :n_obj, 3] = boxes_img[:, :n_obj, 1] + rng.uniform(
        20, 120, (batch, n_obj))
    bdry = np.zeros((batch, m, 4), bool)
    l2i = np.zeros((batch, m, 4, 4), np.float32)
    l2i[..., 0, 0] = 721.5
    l2i[..., 1, 1] = 721.5
    l2i[..., 0, 2] = 609.6
    l2i[..., 1, 2] = 172.9
    l2i[..., 2, 2] = 1.0
    l2i[..., 3, 3] = 1.0
    ibp = np.zeros((batch, m, pc, 2), np.float32)
    ibp[:, :n_obj] = pseudo[:, :n_obj, None, :2] + rng.randn(
        batch, n_obj, pc, 2).astype(np.float32)
    ibp_valid = np.zeros((batch, m, pc), bool)
    ibp_valid[:, :n_obj, :64] = True
    return dict(points=pts, points_valid=valid, labels=labels,
                obj_valid=obj_valid, init_pseudo=pseudo,
                boxes_img=boxes_img, bdry_masks=bdry, lidar2img=l2i,
                ibp_xy=ibp, ibp_valid=ibp_valid)


def fail(msg):
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr)
    sys.exit(1)


def event_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, reps, names):
    """Device time per call of ``fn`` from torch.profiler: the summed
    self device time of the kernels whose names contain one of ``names``
    over ``reps`` calls, after one warm-up; None where the profiler saw
    none of them (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(n in e.key for n in names))
        if us > 0:
            return us / reps / 1e3
    return None


def host_ms(torch, fn, calls=100):
    """Host time per call of ``fn``: a host clock around ``calls`` calls,
    read before the synchronize that follows them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def fmt_ms(ms):
    return 'not measured' if ms is None else f'{ms:.4f} ms'


def within_bf16_tolerance(torch, out, ref):
    """(ok, max |out - ref|) for |out - ref| <= 1e-2 max|ref| + ulp(ref)."""
    out, ref = out.float(), ref.float()
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    err = (out - ref).abs()
    ok = bool((err <= 1e-2 * ref.abs().max() + ulp).all())
    return ok, float(err.max())


def within_tolerance(torch, out, ref, rtol):
    """(ok, max |out - ref|): the bf16 tolerance where ``rtol`` is None,
    else |out - ref| <= rtol max|ref|."""
    if rtol is None:
        return within_bf16_tolerance(torch, out, ref)
    err = float((out.float() - ref.float()).abs().max())
    return err <= rtol * float(ref.float().abs().max()), err


def dtype_name(torch, t):
    """'float32' or 'bfloat16': the GATES key of a tensor's dtype."""
    return 'float32' if t.dtype == torch.float32 else 'bfloat16'


def kernel_key(torch, name, t):
    """The kernel's name in KERNEL_NAMES and the kernels line: the f32
    entries carry a suffix."""
    return name + '_f32' if t.dtype == torch.float32 else name


@contextlib.contextmanager
def recording(module, name, phase=lambda: None):
    """Replace ``module.name`` by a wrapper that records each call's
    (phase, args) and calls the real function."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args):
        calls.append((phase(), args))
        return real(*args)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def wrappers(mods):
    """(module, name) of every kernel wrapper on the train path."""
    sparse_conv, gr, heatmap = mods
    return [(sparse_conv, 'gather_gemm_conv'), (sparse_conv, 'gather_gemm_dw'),
            (gr, 'gather_rows'), (heatmap, 'render_heatmap')]


@contextlib.contextmanager
def plain_versions(swaps):
    """The given kernel wrappers replaced by their plain versions."""
    real = [getattr(m, n) for m, n in swaps]
    for m, n in swaps:
        setattr(m, n, getattr(m, n + '_plain'))
    try:
        yield
    finally:
        for (m, n), f in zip(swaps, real):
            setattr(m, n, f)


def rows_read(torch, idx):
    """Distinct source rows an index map hits (-1 = miss): the rows a
    gather has to read, each once."""
    return int(torch.unique(idx[idx >= 0]).numel())


def bound_ms(nbytes, flops, peak):
    """(bytes ms, operations ms) of the card's least time for the work."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3


def conv_row(torch, sparse_conv, f, nmap, w, label):
    """Replay one gather_gemm_conv call: check against plain, time both."""
    real = sparse_conv.gather_gemm_conv
    plain = sparse_conv.gather_gemm_conv_plain
    out = real(f, nmap, w)
    ref = plain(f, nmap, w)
    torch.cuda.synchronize()
    ok, err = within_tolerance(torch, out, ref,
                               GATES[dtype_name(torch, f)]['conv'])
    if not ok:
        fail(f'{label}: gather_gemm_conv {f.dtype} (K, C, D) = '
             f'{tuple(w.shape)} disagrees with the plain version, max abs '
             f'err {err}')
    if f.dtype == torch.float32 and not torch.equal(out, real(f, nmap, w)):
        fail(f'{label}: gather_gemm_conv f32 (K, C, D) = {tuple(w.shape)} '
             'gave other bits on a second call')
    R, C = f.shape
    K, Q = nmap.shape
    D = w.shape[2]
    es = f.element_size()
    hits = int((nmap >= 0).sum())
    read = rows_read(torch, nmap)
    nbytes = read * C * es + K * Q * 4 + K * C * D * es + Q * D * es
    flops = 2 * hits * C * D
    b_ms, f_ms = bound_ms(nbytes, flops,
                          TF32X3_FLOPS if es == 4 else BF16_FLOPS)
    return dict(K=K, C=C, D=D, R=R, Q=Q, hits=hits, rows_read=read,
                bytes=nbytes, flops=flops, max_abs_err=err,
                **f32_extras(torch, nmap, flops, es,
                             f32_row_group('conv', C, D)),
                max_abs_plain=float(ref.float().abs().max()),
                ms=event_ms(torch, lambda: real(f, nmap, w), 20),
                device_ms=device_ms(
                    torch, lambda: real(f, nmap, w), 20,
                    KERNEL_NAMES[kernel_key(torch, 'gather_gemm_conv', f)]),
                plain_ms=event_ms(torch, lambda: plain(f, nmap, w), 5),
                bytes_ms=b_ms, flops_ms=f_ms)


def multiplied_rows(torch, nmap, tile):
    """Rows an f32 kernel multiplies: per offset, ``tile`` rows for every
    ``tile``-row group of Q that the offset hits at least once."""
    K, Q = nmap.shape
    hit = torch.nn.functional.pad(nmap >= 0, (0, (-Q) % tile))
    return int(hit.reshape(K, -1, tile).any(-1).sum()) * tile


def f32_extras(torch, nmap, flops, es, tile):
    """For an f32 call: the rows its kernel multiplies and the FFMA
    bound (67 TFLOP/s, the f32 kernels' rate before 3xTF32), so that
    shares stay comparable with the FFMA designs'."""
    if es != 4:
        return dict(mult_rows=None, ffma_ms=None)
    return dict(mult_rows=multiplied_rows(torch, nmap, tile),
                ffma_ms=flops / F32_FLOPS * 1e3)


def ffma_bound(rows):
    """The f32 rows' bound at the FFMA rate, each call's larger of its
    bytes and FFMA times."""
    return sum(max(r['bytes_ms'], r['ffma_ms']) for r in rows)


def sum_device_ms(rows):
    """Summed device_ms of the rows, None if any row was not measured."""
    ms = [r['device_ms'] for r in rows]
    return None if None in ms else sum(ms)


def share(bound, ms):
    return 'not measured' if ms is None else f'{100 * bound / ms:.1f}%'


def print_conv_rows(title, rows):
    print(title + '; ms by CUDA events around 20 calls, dev_ms by the '
          'profiler\'s device clock')
    print(f'{"K":>3} {"C":>4} {"D":>4} {"calls":>5} {"Q":>7} {"hits":>9} '
          f'{"MB":>8} {"GFLOP":>7} {"ms":>8} {"dev_ms":>8} {"plain_ms":>9} '
          f'{"bound_ms":>9} {"share":>6} {"dev_share":>9} {"max_err":>8}'
          + (f' {"ffma_bound":>10} {"ffma_dev_share":>14} {"mult/hit":>8}'
             if rows[0]['ffma_ms'] is not None else ''))
    shapes = {}
    for r in rows:
        shapes.setdefault((r['K'], r['C'], r['D']), []).append(r)
    for (K, C, D), rs in shapes.items():
        s = {k: sum(r[k] for r in rs) for k in
             ('hits', 'bytes', 'flops', 'ms', 'plain_ms')}
        bound = sum(max(r['bytes_ms'], r['flops_ms']) for r in rs)
        dev = sum_device_ms(rs)
        dev_s = 'not measured' if dev is None else f'{dev:.4f}'
        print(f'{K:>3} {C:>4} {D:>4} {len(rs):>5} {rs[0]["Q"]:>7} '
              f'{s["hits"]:>9} {s["bytes"] / 1e6:>8.2f} '
              f'{s["flops"] / 1e9:>7.2f} {s["ms"]:>8.4f} '
              f'{dev_s:>8} {s["plain_ms"]:>9.4f} {bound:>9.5f} '
              f'{share(bound, s["ms"]):>6} {share(bound, dev):>9} '
              f'{max(r["max_abs_err"] for r in rs):>8.4f}'
              + (f' {ffma_bound(rs):>10.5f} {share(ffma_bound(rs), dev):>14} '
                 f'{sum(r["mult_rows"] for r in rs) / max(s["hits"], 1):>8.2f}'
                 if rs[0]['ffma_ms'] is not None else ''))


def kernel_phase(torch, sparse_conv, bundle, pts, val, n_convs,
                 label='kernel phase'):
    with recording(sparse_conv, 'gather_gemm_conv') as calls:
        with torch.no_grad():
            bundle.model(pts, val)
    torch.cuda.synchronize()
    if len(calls) != n_convs:
        fail(f'{label}: expected {n_convs} sparse conv calls, saw '
             f'{len(calls)}')
    with torch.no_grad():
        rows = [conv_row(torch, sparse_conv, *args, f'{label} call {i}')
                for i, (_, args) in enumerate(calls)]
    print_conv_rows(f'{label}: gather_gemm_conv vs plain at the path\'s '
                    f'{n_convs} calls (bytes = feature rows hit + nmap + '
                    'weights + out, each once; flops = 2 * hits * C * D)',
                    rows)
    return rows


def slice_phase(torch, sparse_conv, apis, bundle, batches, n_convs,
                label='slice phase'):
    """Main path: the counts are set to 0 just before and read just after."""
    apis.infer(bundle, *batches[0])                       # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sparse_conv.launches = 0
    start.record()
    outs = [apis.infer(bundle, *b) for b in batches[1:]]
    end.record()
    torch.cuda.synchronize()
    launches = sparse_conv.launches
    n_fwd = len(batches) - 1
    if launches != n_convs * n_fwd:
        fail(f'{label}: {launches} kernel launches for {n_fwd} forwards,'
             f' expected {n_convs * n_fwd}')
    ms = start.elapsed_time(end)
    n_valid = 0
    for out in outs:
        n = 3 * bundle.cfg.max_per_task
        if out['boxes'].shape != (B, n, 7) or out['scores'].shape != (B, n):
            fail(f'{label}: output shapes {out["boxes"].shape}')
        for key in ('boxes', 'scores'):
            if not torch.isfinite(out[key]).all():
                fail(f'{label}: non-finite {key}')
        n_valid += int(out['valid'].sum())
    if n_valid == 0:
        fail(f'{label}: no valid detection')
    return dict(launches=launches, forwards=n_fwd, ms=ms,
                scenes_per_s=B * n_fwd / (ms / 1e3),
                valid_detections=n_valid)


def breakdown(torch, bundle, batches):
    """Device ms per stage of one infer, mean over the batches."""
    from gga_tpu_torch.models.detectors.centerpoint_gga import \
        decode_detections
    m = bundle.model
    names = ('voxelize+encoder', 'backbone+neck+head', 'decode+nms')
    acc = dict.fromkeys(names, 0.0)
    with torch.no_grad():
        for pts, val in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            bev = m.extract_bev(pts, val)
            ev[1].record()
            preds = m.pts_bbox_head(m.pts_neck(m.pts_backbone(bev)))
            ev[2].record()
            decode_detections(bundle.cfg, preds)
            ev[3].record()
            torch.cuda.synchronize()
            for i, name in enumerate(names):
                acc[name] += ev[i].elapsed_time(ev[i + 1]) / len(batches)
    return acc


def device_profile(torch, fn, top=12):
    """``fn()`` under torch.profiler: device busy share of the window and
    the kernels with the most device time (one stream, so kernel times
    do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    ops.sort(key=lambda e: -e.self_device_time_total)
    return dict(window_ms=window_ms, busy_ms=busy_ms,
                busy_share=busy_ms / window_ms if window_ms else None,
                kernel_launches=sum(e.count for e in ops),
                top=[dict(name=e.key, calls=e.count,
                          device_ms=e.self_device_time_total / 1e3)
                     for e in ops[:top]])


def print_profile(label, prof):
    if prof['busy_ms'] == 0:
        print(f'{label} profile: the profiler saw no device time (not '
              'measured)')
        return
    print(f'{label} profile: device busy {prof["busy_ms"]:.2f} of '
          f'{prof["window_ms"]:.2f} ms ({100 * prof["busy_share"]:.1f}%)'
          f' over {prof["kernel_launches"]} kernel launches; '
          'top kernels by device time:')
    for op in prof['top']:
        print(f'  {op["device_ms"]:8.3f} ms {op["calls"]:5d}x '
              f'{op["name"][:90]}')


def plain_comparison(torch, mods, bundle, pts, val):
    """BEV map and head logits with the kernels vs with the plain versions,
    within the forward gate of the model's dtype."""
    m = bundle.model

    def run():
        with torch.no_grad():
            bev = m.extract_bev(pts, val)
            preds = m.pts_bbox_head(m.pts_neck(m.pts_backbone(bev)))
        return bev, [p['heatmap'] for p in preds]

    bev_k, hm_k = run()
    with plain_versions(wrappers(mods)):
        bev_p, hm_p = run()
    torch.cuda.synchronize()
    result = {}
    for name, a, b in [('bev', bev_k, bev_p)] + [
            (f'heatmap_logits_task{t}', x, y)
            for t, (x, y) in enumerate(zip(hm_k, hm_p))]:
        ok, err = within_tolerance(
            torch, a, b, GATES[bundle.cfg.compute_dtype]['forward'])
        result[name] = dict(max_abs_err=err,
                            max_abs_plain=float(b.float().abs().max()))
        if not ok:
            fail(f'plain comparison: {name} differs, max abs err {err}')
    return result


def counts(mods):
    sparse_conv, gr, heatmap = mods
    return dict(gather_gemm_conv=sparse_conv.launches,
                gather_gemm_dw=sparse_conv.dw_launches,
                gather_rows=gr.launches, gather_rows_t=gr.t_launches,
                render_heatmap=heatmap.launches)


def zero_counts(mods):
    sparse_conv, gr, heatmap = mods
    sparse_conv.launches = sparse_conv.dw_launches = 0
    gr.launches = gr.t_launches = 0
    heatmap.launches = 0


def recorded_step(torch, apis, sp, mods, trainer, batch):
    """One train step that records the arguments of every kernel call,
    with the stage each came in, and the strided convs' forward maps."""
    sparse_conv, gr, heatmap = mods
    order = ('forward', 'loss', 'backward', 'optimizer')
    stage = ['forward']

    def mark(name):
        stage[0] = order[min(order.index(name) + 1, len(order) - 1)]

    rulebook = sp.downsample_rulebook_compact
    maps = []

    def keep_maps(*args, **kwargs):
        out = rulebook(*args, **kwargs)
        maps.append(out[3])
        return out

    with contextlib.ExitStack() as stack:
        rec = {name: stack.enter_context(recording(mod, name,
                                                   lambda: stage[0]))
               for mod, name in ((sparse_conv, 'gather_gemm_conv'),
                                 (sparse_conv, 'gather_gemm_dw'),
                                 (gr, 'gather_rows'),
                                 (heatmap, 'render_heatmap'))}
        sp.downsample_rulebook_compact = keep_maps
        stack.callback(setattr, sp, 'downsample_rulebook_compact', rulebook)
        logs = apis.train_step(trainer, batch, mark)
    torch.cuda.synchronize()
    return logs, rec, maps


def finite_logs(torch, logs, label):
    for key, v in logs.items():
        if not torch.isfinite(v).all():
            fail(f'{label}: {key} is not finite ({v})')


def train_phase(torch, apis, mods, trainer, batches, label='train phase'):
    """Main path: the counts are set to 0 just before the timed steps and
    read just after. Returns the phase's numbers."""
    params0 = {n: p.detach().clone()
               for n, p in trainer.model.named_parameters()}
    stats0 = {n: b.detach().clone()
              for n, b in trainer.model.named_buffers()}
    torch.cuda.synchronize()
    names = ('forward', 'targets+loss', 'backward', 'clip+optimizer')
    stage_ms = dict.fromkeys(names, 0.0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    all_logs, events = [], []
    zero_counts(mods)
    start.record()
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        marks = iter(ev[1:])
        all_logs.append(apis.train_step(trainer, b,
                                        lambda _: next(marks).record()))
        events.append(ev)
    end.record()
    torch.cuda.synchronize()
    got = counts(mods)
    ms = start.elapsed_time(end)
    n = len(batches)
    for name, per in PER_STEP.items():
        if got[name] != per * n:
            fail(f'{label}: {got[name]} {name} launches in {n} steps, '
                 f'expected {per * n}')
    if got['gather_rows_t'] != 0:
        fail(f'{label}: gather_rows_t ran on the main path')
    for logs, ev in zip(all_logs, events):
        for i, name in enumerate(names):
            stage_ms[name] += ev[i].elapsed_time(ev[i + 1]) / n
        finite_logs(torch, logs, label)
    moved = sum(int(not torch.equal(p, params0[k]))
                for k, p in trainer.model.named_parameters())
    if moved != len(params0):
        fail(f'{label}: only {moved} of {len(params0)} parameter '
             'tensors changed')
    bn_moved = sum(int(not torch.equal(b, stats0[k])
                       and bool(torch.isfinite(b).all()))
                   for k, b in trainer.model.named_buffers())
    if bn_moved != len(stats0):
        fail(f'{label}: only {bn_moved} of {len(stats0)} batch-norm '
             'statistics moved and stayed finite')
    last = {k: float(v) for k, v in all_logs[-1].items()}
    return dict(launches=got, steps=n, ms=ms,
                scenes_per_s=B * n / (ms / 1e3), breakdown=stage_ms,
                losses=[float(lg['loss']) for lg in all_logs],
                grad_norms=[float(lg['grad_norm']) for lg in all_logs],
                last_logs=last, params_moved=moved, bn_stats_moved=bn_moved)


def dw_rows(torch, sparse_conv, calls, label='train kernels'):
    rows = []
    real, plain = sparse_conv.gather_gemm_dw, sparse_conv.gather_gemm_dw_plain
    for i, (_, (f, nmap, dout)) in enumerate(calls):
        out = real(f, nmap, dout)
        again = real(f, nmap, dout)
        ref = plain(f, nmap, dout)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            fail(f'{label}: gather_gemm_dw call {i} {tuple(out.shape)} '
                 'gave other bits on a second call')
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        rtol = GATES[dtype_name(torch, f)]['dw']
        if not err <= rtol * scale:
            fail(f'{label}: gather_gemm_dw {f.dtype} call {i} '
                 f'{tuple(out.shape)} max abs err {err} > {rtol} * {scale}')
        R, C = f.shape
        K, Q = nmap.shape
        D = dout.shape[1]
        es = f.element_size()
        hits = int((nmap >= 0).sum())
        read = rows_read(torch, nmap)
        nbytes = read * C * es + K * Q * 4 + Q * D * es + K * C * D * 4
        flops = 2 * hits * C * D
        b_ms, f_ms = bound_ms(nbytes, flops,
                              TF32X3_FLOPS if es == 4 else BF16_FLOPS)
        rows.append(dict(K=K, C=C, D=D, R=R, Q=Q, hits=hits, rows_read=read,
                         bytes=nbytes, flops=flops, max_abs_err=err,
                         **f32_extras(torch, nmap, flops, es,
                                      f32_row_group('dw', C, D)),
                         max_abs_plain=scale,
                         ms=event_ms(torch, lambda: real(f, nmap, dout), 20),
                         device_ms=device_ms(
                             torch, lambda: real(f, nmap, dout), 20,
                             KERNEL_NAMES[kernel_key(torch, 'gather_gemm_dw',
                                                     f)]),
                         plain_ms=event_ms(torch, lambda: plain(f, nmap, dout),
                                           5),
                         bytes_ms=b_ms, flops_ms=f_ms))
    print_conv_rows(f'{label}: gather_gemm_dw vs plain at the step\'s '
                    f'{len(rows)} calls (bytes = feature rows hit + nmap + '
                    'dout + f32 out; flops = 2 * hits * C * D)', rows)
    return rows


def rows_rows(torch, gr, calls, transposed):
    """gather_rows (or gather_rows_t on (features, map) pairs) vs plain,
    exact; gather_rows also against index_select on a zero-padded source."""
    name = 'gather_rows_t' if transposed else 'gather_rows'
    real, plain = getattr(gr, name), getattr(gr, name + '_plain')
    rows = []
    for i, (src, idx) in enumerate(calls):
        out = real(src, idx)
        ref = plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f'train kernels: {real.__name__} call {i} differs from the '
                 'plain version')
        esize = src.element_size()
        read = rows_read(torch, idx)
        nbytes = (read * src.shape[1] * esize + idx.numel() * 4
                  + out.numel() * esize)
        row = dict(N=src.shape[0], C=src.shape[1], idx=tuple(idx.shape),
                   misses=int((idx < 0).sum()), rows_read=read, bytes=nbytes,
                   max_abs_err=0.0,
                   ms=event_ms(torch, lambda: real(src, idx), 20),
                   device_ms=device_ms(torch, lambda: real(src, idx), 20,
                                       KERNEL_NAMES[name]),
                   plain_ms=event_ms(torch, lambda: plain(src, idx), 20),
                   bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops_ms=0.0,
                   library_ms=None, host_ms=None)
        if transposed:
            row['host_ms'] = host_ms(torch, lambda: real(src, idx))
        else:
            src0 = torch.cat([src.new_zeros(1, src.shape[1]), src])
            idx1 = (idx + 1).long()
            if not torch.equal(torch.index_select(src0, 0, idx1), out):
                fail('train kernels: index_select yardstick disagrees')
            row['library_ms'] = event_ms(
                torch, lambda: torch.index_select(src0, 0, idx1), 20)
        rows.append(row)
    print(f'train kernels: {name} vs plain (exact) at {len(rows)} calls '
          '(bytes = source rows hit + indices + output, each once; ms by '
          'CUDA events, device by the profiler)')
    for r in rows:
        lib = ('' if r['library_ms'] is None
               else f', index_select {r["library_ms"]:.4f} ms')
        host = ('' if r['host_ms'] is None
                else f', host {r["host_ms"]:.4f} ms a call')
        print(f'  src [{r["N"]}, {r["C"]}] idx {r["idx"]} misses '
              f'{r["misses"]}, rows read {r["rows_read"]}: {r["ms"]:.4f} ms, '
              f'device {fmt_ms(r["device_ms"])}, plain '
              f'{r["plain_ms"]:.4f} ms, bound {r["bytes_ms"]:.5f} ms '
              f'(share {share(r["bytes_ms"], r["ms"])}, device '
              f'{share(r["bytes_ms"], r["device_ms"])}){lib}{host}')
    return rows


def heatmap_rows(torch, heatmap, calls):
    rows = []
    real, plain = heatmap.render_heatmap, heatmap.render_heatmap_plain
    for centers, radii, valid, hw in (args for _, args in calls):
        def call():
            return real(centers, radii, valid, hw)
        out = real(centers, radii, valid, hw)
        ref = plain(centers, radii, valid, hw)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= 1e-6 or not torch.equal(out == 1.0, ref == 1.0):
            fail(f'train kernels: render_heatmap differs from plain, max abs '
                 f'err {err}')
        H, W = hw
        G, M = radii.shape
        # operations this run's objects need: ~8 f32 ops (2 sub, 2 mul,
        # add, div, exp, max) per (pixel, object) pair inside a window
        cx, cy = centers[..., 0].long(), centers[..., 1].long()
        r = radii.long()
        wx = ((cx + r).clamp(max=W - 1) - (cx - r).clamp(min=0)
              + 1).clamp(min=0)
        wy = ((cy + r).clamp(max=H - 1) - (cy - r).clamp(min=0)
              + 1).clamp(min=0)
        pairs = int((wx * wy * valid).sum())
        # a valid flag per slot; centre and radius of each live object
        nbytes = G * M + int(valid.sum()) * (8 + 4) + out.numel() * 4
        b_ms, f_ms = bound_ms(nbytes, 8 * pairs, F32_FLOPS)
        rows.append(dict(G=G, M=M, H=H, W=W, live=int(valid.sum()),
                         pairs=pairs, bytes=nbytes, flops=8 * pairs,
                         max_abs_err=err, ones=int((ref == 1.0).sum()),
                         ms=event_ms(torch, call, 20),
                         device_ms=device_ms(torch, call, 20,
                                             KERNEL_NAMES['render_heatmap']),
                         host_ms=host_ms(torch, call),
                         plain_ms=event_ms(torch, lambda: plain(
                             centers, radii, valid, hw), 5),
                         bytes_ms=b_ms, flops_ms=f_ms))
    for r in rows:
        bound = max(r['bytes_ms'], r['flops_ms'])
        print(f'train kernels: render_heatmap vs plain: {r["G"]} maps of '
              f'{r["H"]}x{r["W"]}, {r["live"]} live of {r["G"] * r["M"]} '
              f'objects, {r["ones"]} centre pixels; max err '
              f'{r["max_abs_err"]:.3g}; {r["ms"]:.4f} ms by CUDA events, '
              f'device {fmt_ms(r["device_ms"])} (share '
              f'{share(bound, r["device_ms"])}), host {r["host_ms"]:.4f} ms '
              f'a call, plain {r["plain_ms"]:.4f} ms, bound {bound:.5f}'
              f' ms ({r["bytes"]} bytes, {r["flops"]} ops)')
    return rows


def loss_and_grads(torch, trainer, batch, srl):
    """One step's loss, gradient norm, sparse conv weight gradients and
    batch-norm statistics updates, without the optimizer; the running
    statistics are restored afterwards."""
    from gga_tpu_torch.models.dense_heads import centerpoint_head_gga as gga
    from gga_tpu_torch.models.layers import SubMConv3d, SparseConv3d
    model = trainer.model
    head = model.cfg.head
    model.train()
    model.zero_grad(set_to_none=True)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    diag = {}
    preds = model(batch['points'], batch['points_valid'], diag)
    targets = gga.build_targets(head, srl, batch['labels'],
                                batch['obj_valid'], batch['init_pseudo'],
                                batch['boxes_img'], batch['bdry_masks'],
                                batch['lidar2img'])
    total, _ = gga.loss(head, preds, targets, batch['ibp_xy'],
                        batch['ibp_valid'])
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    conv_grads = {n: m.weight.grad.detach().clone()
                  for n, m in model.named_modules()
                  if isinstance(m, (SubMConv3d, SparseConv3d))}
    stat_moves = {}
    with torch.no_grad():
        for n, b in model.named_buffers():
            stat_moves[n] = b - stats0[n]
            b.copy_(stats0[n])
    return float(total.detach()), norm, conv_grads, stat_moves


@contextlib.contextmanager
def input_ulp_noise(torch, model):
    """The sparse encoder's input (the VFE output) moved up by one ulp of
    its dtype in a seeded half of its nonzero entries: a perturbation as
    small as one rounding step, to measure how far the step's gradients
    move under rounding alone."""
    enc = model.pts_middle_encoder
    real = enc.forward

    def noisy(feats, *args, **kwargs):
        g = torch.Generator(device=feats.device).manual_seed(0)
        bump = (torch.rand(feats.shape, generator=g, device=feats.device)
                < 0.5) & (feats != 0)
        bits = feats.view(torch.int16 if feats.element_size() == 2
                          else torch.int32)
        return real((bits + bump.to(bits.dtype)).view(feats.dtype), *args,
                    **kwargs)

    enc.forward = noisy
    try:
        yield
    finally:
        enc.forward = real


def step_comparison(torch, mods, trainer, batch):
    """Loss and gradients of one step with the kernels vs the plain
    versions, same weights, batch and SRL draw, within the gates of the
    model's dtype. The step's rounding noise is read without the kernels:
    the plain step against the plain step with a one-ulp perturbation (of
    the model's dtype) of the encoder input."""
    gate = GATES[trainer.model.cfg.compute_dtype]
    srl = torch.randn((3, B), generator=torch.Generator().manual_seed(5)).to(
        batch['labels'].device)
    loss_k, norm_k, g_k, bn_k = loss_and_grads(torch, trainer, batch, srl)
    with plain_versions(wrappers(mods)):
        loss_p, norm_p, g_p, bn_p = loss_and_grads(torch, trainer, batch,
                                                   srl)
        with input_ulp_noise(torch, trainer.model):
            _, norm_n, g_n, _ = loss_and_grads(torch, trainer, batch, srl)

    def cosines(a, b):
        return {n: float(torch.nn.functional.cosine_similarity(
            a[n].flatten(), b[n].flatten(), dim=0)) for n in a}

    cos, cos_noise = cosines(g_k, g_p), cosines(g_p, g_n)
    # each batch-norm buffer's update agrees within the gate of its
    # largest entry (means and variances in f32 of activations that
    # differ by rounding)
    bn_err = {n: float((bn_k[n] - bn_p[n]).abs().max()
                       / bn_p[n].abs().max().clamp(min=1e-12)) for n in bn_p}
    if not all(torch.isfinite(v).all() for v in bn_k.values()):
        fail('step comparison: non-finite batch-norm statistics')
    worst_bn = max(bn_err, key=bn_err.get)
    if not bn_err[worst_bn] <= gate['bn']:
        fail(f'step comparison: batch-norm update of {worst_bn} differs by '
             f'{bn_err[worst_bn]} of its largest entry')
    res = dict(loss_kernel=loss_k, loss_plain=loss_p,
               loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               grad_norm_kernel=norm_k, grad_norm_plain=norm_p,
               grad_norm_rel=abs(norm_k - norm_p) / norm_p,
               grad_norm_rel_plain_ulp_noise=abs(norm_n - norm_p) / norm_p,
               conv_weight_grads=len(cos), min_cosine=min(cos.values()),
               min_cosine_plain_ulp_noise=min(cos_noise.values()),
               bn_update_max_rel_err=bn_err[worst_bn], bn_buffers=len(bn_err),
               cosines=cos, cosines_plain_ulp_noise=cos_noise)
    if len(cos) != N_CONVS:
        fail(f'step comparison: {len(cos)} sparse conv weight gradients, '
             f'expected {N_CONVS}')
    if not res['loss_rel'] <= gate['loss']:
        fail(f'step comparison: loss {loss_k} vs plain {loss_p}')
    if not res['grad_norm_rel'] <= gate['norm']:
        fail(f'step comparison: grad norm {norm_k} vs plain {norm_p}')
    # cosine >= cos_min, or, where one ulp at the input already moves the
    # plain step's gradient further, no more than twice that far from it
    # and never below the fixed floor
    for n, c in cos.items():
        if not (c >= gate['cos_min'] or (
                c >= gate['cos_floor'] and 1 - c <= 2 * (1 - cos_noise[n]))):
            fail(f'step comparison: {n} weight gradient cosine {c} < '
                 f'{gate["cos_min"]} and beyond twice the plain step\'s '
                 f'one-ulp noise (cosine {cos_noise[n]}) or '
                 f'{gate["cos_floor"]}')
    return res


def kernel_entry(name, source, replaces, launches, rows, library_ms=None):
    bytes_ms = sum(r['bytes_ms'] for r in rows)
    flops_ms = sum(r['flops_ms'] for r in rows)
    ms = sum(r['ms'] for r in rows)
    dev = sum_device_ms(rows)
    host = [r.get('host_ms') for r in rows]
    bound = sum(max(r['bytes_ms'], r['flops_ms']) for r in rows)
    return dict(
        name=name, route='cuda', source=f'gga_tpu_torch/kernels/csrc/{source}',
        replaces=replaces, launches=launches,
        max_abs_err=max(r['max_abs_err'] for r in rows), ms=ms,
        device_ms=dev, plain_ms=sum(r['plain_ms'] for r in rows),
        bound_ms=bound,
        bound_by='bytes' if bytes_ms >= flops_ms else 'operations',
        library_ms=library_ms, bound_share=bound / ms,
        device_bound_share=None if dev is None else bound / dev,
        host_ms=None if None in host else sum(host),
        ffma_bound_ms=(None if rows[0].get('ffma_ms') is None
                       else ffma_bound(rows)))


# --- the GGA workflow through the port's command-line tools ---------------
WF_CONFIG = 'configs/gga/gga_kitti.py'
WF_MATCHING = 'configs/gga/gga_kitti_matching.py'
WF_SPLITS = (8, 8)          # train, val scenes of the mini KITTI
WF_POINTS = 120000          # raw lidar points a scene
WF_STEPS = (4, 6)           # --max-steps of the first run, of the resume
WF_OPTIONS = ('log_interval=1',)
WF_AUG_SCENES = 2           # val scenes of the --aug-test run
# KITTI-like calibration (velodyne x forward -> camera z forward)
VELO2CAM = np.array([[0., -1., 0., 0.], [0., 0., -1., -0.08],
                     [1., 0., 0., -0.27], [0., 0., 0., 1.]])
P2 = np.array([[721.54, 0., 609.56, 44.86], [0., 721.54, 172.85, 0.216],
               [0., 0., 1., 0.0027], [0., 0., 0., 1.]])
IMG_SHAPE = (375, 1242)
# class: (dims l, w, h in m, share of the objects)
WF_CLASSES = dict(Car=((3.9, 1.6, 1.56), 0.5),
                  Pedestrian=((0.8, 0.6, 1.73), 0.25),
                  Cyclist=((1.76, 0.6, 1.73), 0.25))


def render_image(points, img_shape=IMG_SHAPE):
    """Depth-coded point-splat rendering of a lidar scene, RGB uint8 (a
    copy of tests/test_data/fixtures.py:63 render_scene_image): each
    point in the camera's view paints a 2 x 2 splat, red for 8 m over its
    depth, green for its height, blue 255, near points over far ones."""
    pts = np.asarray(points, np.float64)[:, :3]
    cam = (VELO2CAM @ np.concatenate([pts, np.ones((len(pts), 1))], 1).T
           ).T[:, :3]
    z = cam[:, 2]
    uvw = (P2[:3, :3] @ cam.T).T + P2[:3, 3]
    u = uvw[:, 0] / np.maximum(uvw[:, 2], 1e-6)
    v = uvw[:, 1] / np.maximum(uvw[:, 2], 1e-6)
    H, W = img_shape
    ok = (z > 0.5) & (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
    order = np.argsort(-z[ok])
    ui = u[ok].astype(np.intp)[order]
    vi = v[ok].astype(np.intp)[order]
    depth_c = np.clip(255.0 * 8.0 / z[ok], 0, 255).astype(np.uint8)[order]
    height_c = np.clip((pts[ok, 2] + 3.0) / 6.0 * 255.0, 0,
                       255).astype(np.uint8)[order]
    img = np.zeros((H, W, 3), np.uint8)
    for dv in (0, 1):
        for du in (0, 1):
            img[vi + dv, ui + du, 0] = depth_c
            img[vi + dv, ui + du, 1] = height_c
            img[vi + dv, ui + du, 2] = 255
    return img


def png_bytes(img):
    """An 8-bit RGB PNG of ``img`` [H, W, 3] whose row y is filtered with
    type y % 5 (None, Sub, Up, Average, Paeth; PNG spec section 9), so a
    reader meets all five."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack('>I', len(data)) + kind + data
                + struct.pack('>I', zlib.crc32(kind + data) & 0xffffffff))
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
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


def mini_kitti_scene(rng, n_points):
    """One KITTI-scale scene: a 64-beam scan of ground and walls (lidar at
    1.73 m, -24.8 to +2 degrees), 8-16 Car / Pedestrian / Cyclist boxes
    5.5-40 m ahead inside the camera's view, their points, and a
    reflectance. Returns (points [n_points, 4] f32, boxes [N, 7] lidar
    bottom-centre, names)."""
    n_obj = rng.randint(8, 17)
    names, boxes = [], []
    classes = list(WF_CLASSES)
    shares = [WF_CLASSES[c][1] for c in classes]
    while len(boxes) < n_obj:
        name = classes[rng.choice(len(classes), p=shares)]
        x = rng.uniform(5.5, 40.0)
        y = x * np.tan(np.deg2rad(rng.uniform(-30, 30)))
        if any(np.hypot(x - b[0], y - b[1]) < 4.0 for b in boxes):
            continue
        dims = np.array(WF_CLASSES[name][0]) * rng.uniform(0.9, 1.1, 3)
        boxes.append([x, y, -1.73, *dims, rng.uniform(-np.pi, np.pi)])
        names.append(name)
    boxes = np.array(boxes)
    obj_pts = []
    for b in boxes:
        dist = np.hypot(b[0], b[1])
        n = int(np.clip(4000 * b[3] * b[5] / dist, 50, 700))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * b[3:6]
        local[:, 2] += b[5] / 2
        c, s = np.cos(b[6]), np.sin(b[6])
        obj_pts.append(np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                                 local[:, 0] * s + local[:, 1] * c + b[1],
                                 local[:, 2] + b[2]], 1))
    obj_pts = np.concatenate(obj_pts)
    # the scan: beams at uniform elevation and azimuth; a beam returns
    # from the ground, or from a wall 15-70 m out where one stands (40 %)
    n_scan = n_points - len(obj_pts)
    m = 2 * n_scan
    elev = np.deg2rad(rng.uniform(-24.8, 2.0, m))
    azim = rng.uniform(-np.pi, np.pi, m)
    r = np.where(elev < 0, 1.73 / np.tan(-np.minimum(elev, -1e-3)), np.inf)
    wall = rng.uniform(15, 70, m)
    hit_wall = (rng.rand(m) < 0.4) & (wall < r)
    r = np.where(hit_wall, wall, r)
    keep = r < 80
    r, elev, azim = r[keep], elev[keep], azim[keep]
    scan = np.stack([r * np.cos(azim), r * np.sin(azim),
                     np.maximum(r * np.tan(elev), -1.73)], 1)
    scan[:, 2] += rng.randn(len(scan)) * 0.02
    # no wall inside 3 m of an object, so each object's cluster is pure
    near = (np.hypot(scan[:, None, 0] - boxes[None, :, 0],
                     scan[:, None, 1] - boxes[None, :, 1]) < 3.0).any(1)
    scan = scan[~(near & (scan[:, 2] > -1.5))][:n_scan]
    pts = np.concatenate([scan, obj_pts])
    refl = rng.rand(len(pts), 1)
    return (np.concatenate([pts, refl], 1).astype(np.float32), boxes,
            names)


def write_mini_kitti(root, splits=WF_SPLITS, n_points=WF_POINTS, seed=0):
    """A KITTI-format dataset under ``root``: training/{velodyne, calib,
    label_2, image_2} and ImageSets/{train, val}.txt, the images rendered
    from each scene's points (``render_image``, ``png_bytes``). Returns
    the points each scene has in the camera's view."""
    import os

    from gga_tpu_torch.core import np_geometry as ng
    rng = np.random.RandomState(seed)
    sub = os.path.join(root, 'training')
    for d in ('velodyne', 'calib', 'label_2', 'image_2'):
        os.makedirs(os.path.join(sub, d), exist_ok=True)
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)
    in_view, idx = [], 0
    for split, n in zip(('train', 'val'), splits):
        with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'w') as f:
            f.write(''.join(f'{i:06d}\n' for i in range(idx, idx + n)))
        for _ in range(n):
            pts, boxes, names = mini_kitti_scene(rng, n_points)
            pts.tofile(os.path.join(sub, 'velodyne', f'{idx:06d}.bin'))
            in_view.append(len(ng.remove_outside_points(
                pts, np.eye(4), VELO2CAM, P2, IMG_SHAPE)))
            with open(os.path.join(sub, 'calib', f'{idx:06d}.txt'), 'w') as f:
                for k in range(4):
                    P = P2 if k == 2 else np.eye(4)
                    f.write(f'P{k}: ' + ' '.join(
                        f'{v:.12e}' for v in P[:3, :4].reshape(-1)) + '\n')
                f.write('R0_rect: ' + ' '.join(
                    f'{v:.12e}' for v in np.eye(3).reshape(-1)) + '\n')
                for key, mat in (('Tr_velo_to_cam', VELO2CAM),
                                 ('Tr_imu_to_velo', np.eye(4))):
                    f.write(f'{key}: ' + ' '.join(
                        f'{v:.12e}' for v in mat[:3, :4].reshape(-1)) + '\n')
            cam = ng.box_lidar_to_camera(boxes, np.eye(4), VELO2CAM)
            bbox = ng.boxes3d_to_image_bbox(cam, P2, IMG_SHAPE)
            with open(os.path.join(sub, 'label_2', f'{idx:06d}.txt'),
                      'w') as f:
                for name, cb, bb in zip(names, cam, bbox):
                    alpha = cb[6] - np.arctan2(cb[0], cb[2])
                    f.write(f'{name} 0.00 0 {alpha:.2f} {bb[0]:.2f} '
                            f'{bb[1]:.2f} {bb[2]:.2f} {bb[3]:.2f} '
                            f'{cb[4]:.2f} {cb[5]:.2f} {cb[3]:.2f} '
                            f'{cb[0]:.2f} {cb[1]:.2f} {cb[2]:.2f} '
                            f'{cb[6]:.2f}\n')
            with open(os.path.join(sub, 'image_2', f'{idx:06d}.png'),
                      'wb') as f:
                f.write(png_bytes(render_image(pts)))
            idx += 1
    return in_view


def workflow_phase(torch, mods, card, tmp):
    """Stages 1-3 and the stage-4 export through the port's CLIs
    (``main(argv)``, in-process) on a KITTI-format mini dataset in
    ``tmp``, with the shipped configs as shipped (full width, f32). Main
    path: the counts are set to 0 just before each CLI and read just
    after."""
    import json as json_
    import os
    import pickle

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.core.merge_augs import tta_transforms
    from gga_tpu_torch.tools import create_data_gga
    from gga_tpu_torch.tools import create_data_gga_retrain_mono as mono_cli
    from gga_tpu_torch.tools import generate_pseudo_labels_gga as stage3
    from gga_tpu_torch.tools import test as test_cli
    from gga_tpu_torch.tools import train
    from gga_tpu_torch.train import checkpoints as ckpt
    from gga_tpu_torch.train.optim import cyclic_cos_schedule

    data, work = os.path.join(tmp, 'kitti'), os.path.join(tmp, 'work')
    in_view = write_mini_kitti(data, WF_SPLITS, WF_POINTS)
    n_scenes = sum(WF_SPLITS)
    print(f'workflow: mini KITTI of {n_scenes} scenes x {WF_POINTS} points, '
          f'{min(in_view)}-{max(in_view)} in the camera\'s view')
    opts = ['--cfg-options', f'data_root={data}/', *WF_OPTIONS]
    res = dict(points_in_view=in_view)

    zero_counts(mods)
    prep = create_data_gga.main(['kitti', '--root-path', data,
                                 '--workers', str(os.cpu_count() or 8)])
    if any(counts(mods).values()):
        fail('workflow: stage 1 launched a kernel')
    res['stage1'] = prep
    print(f'{card}: workflow stage 1 (create_data_gga, {n_scenes} scenes): '
          f'{prep["seconds"]:.2f} s; region grow: {prep["region_grow"]}')

    cfg = Config.fromfile(str(ROOT / WF_CONFIG)).merge_from_options(
        dict(kv.split('=', 1) for kv in opts[1:]))
    batch = cfg.data.samples_per_gpu
    runs = []
    for i, max_steps in enumerate(WF_STEPS):
        argv = [str(ROOT / WF_CONFIG), '--work-dir', work, '--device',
                DEVICE, '--max-steps', str(max_steps), '--no-eval', *opts]
        zero_counts(mods)
        summ = train.main(argv + (['--resume'] if i else []))
        got = counts(mods)
        steps = summ['steps']
        for name, per in PER_STEP.items():
            if got[name] != per * steps:
                fail(f'workflow: train CLI run {i + 1}: {got[name]} {name} '
                     f'launches in {steps} steps, expected {per * steps}')
        if got['gather_rows_t'] != 0:
            fail('workflow: gather_rows_t ran under the train CLI')
        summ['launches'] = got
        runs.append(summ)
        print(f'{card}: workflow train CLI run {i + 1}: steps '
              f'{summ["start_step"]}-{summ["end_step"]} at B={batch}, '
              f'{summ["scenes_per_s"]:.2f} scenes/s after the first step, '
              f'loader included (loader wait '
              f'{100 * summ["loader_wait_share"]:.1f} % of the wall time); '
              f'launches {got}')
    first, resumed = runs
    if (first['start_step'], first['end_step']) != (0, WF_STEPS[0]):
        fail(f'workflow: first train run took steps {first["start_step"]}-'
             f'{first["end_step"]}')
    if (resumed['start_step'], resumed['end_step']) != WF_STEPS:
        fail(f'workflow: the resume ran steps {resumed["start_step"]}-'
             f'{resumed["end_step"]}, expected {WF_STEPS[0]}-{WF_STEPS[1]}')
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json_.loads(ln) for ln in f]
    if [ln['step'] for ln in lines] != list(range(1, WF_STEPS[1] + 1)):
        fail(f'workflow: logged steps {[ln["step"] for ln in lines]}')
    o = cfg.optimizer
    for ln in lines:
        # the grad norm may overflow f32 at random weights (BPL projects
        # boxes of exp(dims) metres; gga_tpu's optax.global_norm does the
        # same), and the clip then zeroes that step: only the loss gates
        if not np.isfinite(ln['loss']):
            fail(f'workflow: step {ln["step"]} loss {ln["loss"]}')
        # step s runs at the schedule's value for optimizer count s - 1 of
        # its run's total (--max-steps caps the total)
        total = WF_STEPS[0] if ln['step'] <= WF_STEPS[0] else WF_STEPS[1]
        want = cyclic_cos_schedule(o.lr, o.lr_target_ratio, o.step_ratio_up,
                                   total)(ln['step'] - 1)
        if not abs(ln['lr'] - want) <= 1e-12 * want:
            fail(f'workflow: step {ln["step"]} ran at lr {ln["lr"]}, the '
                 f'schedule gives {want}')
    res.update(train=runs, losses=[ln['loss'] for ln in lines],
               grad_norms=[ln['grad_norm'] for ln in lines],
               lrs=[ln['lr'] for ln in lines])
    ckpt_dir = os.path.join(work, 'checkpoints')
    kept = ckpt.latest_step(ckpt_dir)
    print(f'{card}: workflow checkpoints: newest step {kept}, '
          f'{first["ckpt_bytes"] / 2 ** 20:.1f} MiB each, save ms '
          f'{[round(v, 1) for v in first["ckpt_save_ms"] + resumed["ckpt_save_ms"]]}'
          f', load (resume) {resumed["ckpt_load_ms"]:.1f} ms')
    print(f'workflow: losses {[f"{v:.5g}" for v in res["losses"]]}, grad '
          f'norms {[f"{v:.4g}" for v in res["grad_norms"]]}, lr '
          f'{[f"{v:.4g}" for v in res["lrs"]]}')

    # stage 3: the first batch's inputs and detections are kept
    seen = []
    real_infer = apis.infer

    def keep_first(bundle, points, points_valid):
        out = real_infer(bundle, points, points_valid)
        if not seen:
            seen.append((points, points_valid, {
                k: v.clone() for k, v in out.items()}))
        return out

    pkl = os.path.join(tmp, 'pseudo', 'kitti_infos_trainval_GGA_pseudo.pkl')
    argv = [str(ROOT / WF_MATCHING), '--checkpoint', ckpt_dir, '--eval',
            '--device', DEVICE, '--out', pkl, *opts]
    apis.infer = keep_first
    zero_counts(mods)
    try:
        s3 = stage3.main(argv)
    finally:
        apis.infer = real_infer
    got = counts(mods)
    n_batches = -(-n_scenes // batch)
    want = dict(gather_gemm_conv=N_CONVS * n_batches, gather_gemm_dw=0,
                gather_rows=0, gather_rows_t=0, render_heatmap=0)
    if got != want:
        fail(f'workflow: stage-3 CLI launches {got}, expected {want}')
    with open(pkl, 'rb') as f:
        pseudo = pickle.load(f)
    if len(pseudo) != n_scenes or s3['infos'] != n_scenes:
        fail(f'workflow: the pseudo pkl holds {len(pseudo)} infos, expected '
             f'{n_scenes}')
    print(f'{card}: workflow stage-3 CLI: {n_scenes} scenes in '
          f'{s3["seconds"]:.2f} s = {s3["scenes_per_s"]:.2f} scenes/s (load '
          f'through matching); launches {got}; pseudo pkl {len(pseudo)} '
          f'infos')
    # the CLI's first batch against apis.infer with the same weights
    points, valid, out = seen[0]
    bundle, _ = apis.init_model(cfg, ckpt_dir, device=DEVICE)
    ref = apis.infer(bundle, points, valid)
    for key, v in out.items():
        if not torch.equal(v, ref[key]):
            fail(f'workflow: stage-3 CLI {key} of the first batch differs '
                 'from apis.infer on the same padded batch and weights')
    # every candidate slot is compared, kept or not: six steps from random
    # weights may leave no box inside the decode's centre range
    n_det = int(out['valid'].sum())
    n_pseudo = sum(len(i['annos']['name']) for i in pseudo)
    print(f'workflow: the stage-3 CLI\'s first batch equals apis.infer on '
          f'the same padded batch ({tuple(points.shape)}) and checkpoint, '
          f'all {out["scores"].numel()} candidate slots (max score '
          f'{float(out["scores"].max()):.4g}): {n_det} kept detections; '
          f'{n_pseudo} matched pseudo labels in the pkl')
    res.update(stage3={k: v for k, v in s3.items() if k != 'ap'},
               stage3_launches=got, first_batch_detections=n_det,
               pseudo_infos=len(pseudo), pseudo_labels=n_pseudo)
    res.update(test_phase(torch, mods, card, tmp, data, ckpt_dir, opts,
                          batch, test_cli, tta_transforms))
    res['mono3d'] = mono_phase(mods, card, pkl, pseudo, mono_cli)
    return res


def test_phase(torch, mods, card, tmp, data, ckpt_dir, opts, batch,
               test_cli, tta_transforms):
    """tools/test.py on the val split (--eval, submission files) and with
    --aug-test on its first WF_AUG_SCENES scenes; the counts are set to 0
    just before each run and read just after."""
    import os
    import pickle

    config = str(ROOT / WF_CONFIG)
    val_info = 'kitti_infos_val_GGA.pkl'
    n_val = WF_SPLITS[1]
    sub_dir = os.path.join(tmp, 'submission')
    zero_counts(mods)
    ev = test_cli.main([config, '--checkpoint', ckpt_dir, '--info', val_info,
                        '--eval', '--format-only', '--submission-dir',
                        sub_dir, '--device', DEVICE, *opts])
    got = counts(mods)
    want = dict(gather_gemm_conv=N_CONVS * -(-n_val // batch),
                gather_gemm_dw=0, gather_rows=0, gather_rows_t=0,
                render_heatmap=0)
    if got != want:
        fail(f'workflow: test CLI launches {got}, expected {want}')
    ev_launches = got
    files = sorted(os.listdir(sub_dir))
    if ev['scenes'] != n_val or len(files) != n_val:
        fail(f'workflow: test CLI wrote {len(files)} submission files for '
             f'{ev["scenes"]} scenes, expected {n_val}')
    if 'KITTI/Car_3D_AP11_moderate_strict' not in ev.get('ap', {}):
        fail('workflow: test CLI --eval gave no KITTI AP')
    print(f'{card}: workflow test CLI (--eval --format-only, {n_val} val '
          f'scenes): {ev["scenes_per_s"]:.2f} scenes/s (inference through '
          f'the annos), {ev["detections"]} detections, {len(files)} '
          f'submission files; launches {got}')

    with open(os.path.join(data, val_info), 'rb') as f:
        val_infos = pickle.load(f)
    aug_info = 'kitti_infos_val_aug_GGA.pkl'
    with open(os.path.join(data, aug_info), 'wb') as f:
        pickle.dump(val_infos[:WF_AUG_SCENES], f)
    aug_dir = os.path.join(tmp, 'submission_aug')
    zero_counts(mods)
    aug = test_cli.main([config, '--checkpoint', ckpt_dir, '--info',
                         aug_info, '--aug-test', '--format-only',
                         '--submission-dir', aug_dir, '--device', DEVICE,
                         *opts])
    got = counts(mods)
    # apis.aug_inference_detector's default variants: 3 scales x h-flip
    variants = len(tta_transforms(scales=(0.95, 1.0, 1.05), flip=True))
    want = dict(gather_gemm_conv=N_CONVS * variants * WF_AUG_SCENES,
                gather_gemm_dw=0, gather_rows=0, gather_rows_t=0,
                render_heatmap=0)
    if got != want:
        fail(f'workflow: test CLI --aug-test launches {got}, expected '
             f'{want} ({variants} variants a scene)')
    if aug['scenes'] != WF_AUG_SCENES or len(
            os.listdir(aug_dir)) != WF_AUG_SCENES:
        fail('workflow: test CLI --aug-test wrote the wrong submission files')
    print(f'{card}: workflow test CLI --aug-test ({WF_AUG_SCENES} scenes x '
          f'{variants} variants): {aug["scenes_per_s"]:.2f} scenes/s, '
          f'{aug["detections"]} detections; launches {got}')
    return dict(test_eval={k: v for k, v in ev.items() if k != 'ap'},
                test_eval_launches=ev_launches, test_aug=aug,
                test_aug_launches=got, tta_variants=variants)


def mono_phase(mods, card, pkl, pseudo, mono_cli):
    """The stage-4 mono3d COCO export of the stage-3 pseudo pkl; host only."""
    import json as json_
    import os

    zero_counts(mods)
    t0 = time.perf_counter()
    out = mono_cli.main(['kitti', '--root-path', os.path.dirname(pkl)])
    seconds = time.perf_counter() - t0
    if any(counts(mods).values()):
        fail('workflow: the mono3d export launched a kernel')
    got = out['trainval_pseudo']
    if got is None:
        fail('workflow: the mono3d export found no pseudo pkl')
    with open(got['json']) as f:
        coco = json_.load(f)
    classes = ('Pedestrian', 'Cyclist', 'Car')
    n_obj = sum(sum(n in classes for n in i['annos']['name'])
                for i in pseudo)
    if not (got['images'] == len(coco['images']) == len(pseudo)
            and got['annotations'] == len(coco['annotations']) == n_obj):
        fail(f'workflow: the mono3d json holds {len(coco["images"])} images '
             f'and {len(coco["annotations"])} annotations, the pseudo infos '
             f'{len(pseudo)} and {n_obj}')
    print(f'{card}: workflow mono3d export: {len(coco["images"])} images, '
          f'{len(coco["annotations"])} annotations in {seconds:.2f} s')
    return dict(got, seconds=seconds)


# --- stage 4: the PGD monocular retrain through the port's CLI ------------
S4_CONFIG = 'configs/gga/gga_pdg.py'
S4_STEPS = (3, 4)           # --max-steps of the first run, of the resume
S4_OPTIONS = ('log_interval=1',)
S4_EVAL_BATCH = 4           # images a batch of evaluate_mono


def forward_flop(torch, model_cfg):
    """FLOPs of the PGD detector's forward on one 384 x 1248 image, counted
    by ``torch.utils.flop_counter`` on the meta device (shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode

    from gga_tpu_torch.models.detectors.pgd import PGDDetector
    with torch.device('meta'):
        model = PGDDetector(model_cfg)
        x = torch.empty(1, 3, 384, 1248)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


def png_timing(card, path):
    """Host ms to read one of the mini KITTI's PNGs (375 x 1242 RGB, all
    five row filters) through the port's reader (zlib + the C++ unfilter)
    and with the numpy unfilter, its oracle; both give the same bytes."""
    from gga_tpu_torch.data.kitti import png
    data = Path(path).read_bytes()
    png.decode_png(data)                            # builds the library
    t0 = time.perf_counter()
    img = png.decode_png(data)
    cpp_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = png.decode_png(data, png.unfilter_numpy)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    if not np.array_equal(img, ref):
        fail('stage 4: the C++ PNG unfilter differs from the numpy one')
    print(f'{card}: stage 4 PNG read of one {img.shape[0]} x {img.shape[1]} '
          f'frame (host): {cpp_ms:.2f} ms with the C++ unfilter, '
          f'{numpy_ms:.1f} ms with the numpy one')
    return dict(cpp_ms=cpp_ms, numpy_ms=numpy_ms)


def stage4_phase(torch, mods, card, tmp):
    """Stage 4 on the workflow's mini KITTI: ``train_pgd`` with the shipped
    configs/gga/gga_pdg.py (ResNet-101 + FPN + PGDHead, f32, B =
    samples_per_gpu = 12) on a pseudo-format pkl of all 16 scenes with
    their ground truth, S4_STEPS[0] steps (one an epoch, a checkpoint at
    each epoch's end), then ``--resume`` to S4_STEPS[1]; a decode from
    the reloaded checkpoint against the in-memory weights; then
    ``tools_lib.evaluate_mono``. Main path: the counts are set to 0 just
    before each CLI run and read just after; no kernel of the port runs
    in stage 4."""
    import json as json_
    import os
    import pickle

    from gga_tpu_torch import apis, tools_lib
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti.mono_dataset import KittiMonoDataset
    from gga_tpu_torch.tools import train_pgd
    from gga_tpu_torch.train import checkpoints as ckpt
    from gga_tpu_torch.train.optim import step_schedule

    data = os.path.join(tmp, 'kitti')
    with open(os.path.join(data, 'kitti_infos_trainval_GGA.pkl'), 'rb') as f:
        infos = pickle.load(f)
    for info in infos:          # pseudo-label format: a score per object
        info['annos']['score'] = np.ones(len(info['annos']['name']))
    pkl = os.path.join(tmp, 'stage4', 'kitti_infos_trainval_GGA_pseudo.pkl')
    os.makedirs(os.path.dirname(pkl), exist_ok=True)
    with open(pkl, 'wb') as f:
        pickle.dump(infos, f)
    res = dict(png=png_timing(card, os.path.join(
        data, infos[0]['image']['image_path'])))

    config = str(ROOT / S4_CONFIG)
    cfg = Config.fromfile(config)
    batch = cfg.data.samples_per_gpu
    model_cfg = tools_lib.model_config_from_cfg(cfg)
    res['forward_flop'] = forward_flop(torch, model_cfg)
    arch = f'ResNet-{model_cfg.backbone_depth}'
    print(f'stage 4: {arch} + FPN + PGDHead forward of one 384 x 1248 image: '
          f'{res["forward_flop"] / 1e12:.4f} TFLOP (counted from shapes); a '
          f'train step of {batch} about 3x that an image, '
          f'{3 * batch * res["forward_flop"] / 1e12:.2f} TFLOP')
    work = os.path.join(tmp, 'work_pgd')
    argv = [config, '--info', pkl, '--data-root', data, '--work-dir', work,
            '--device', DEVICE, '--cfg-options', *S4_OPTIONS]
    trainers, step_ms = [], []
    real_step = apis.pgd_train_step

    def timed_step(trainer, b):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        logs = real_step(trainer, b)
        end.record()
        trainers.append(trainer)
        step_ms.append((start, end))
        return logs

    runs = []
    apis.pgd_train_step = timed_step
    try:
        for i, max_steps in enumerate(S4_STEPS):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            n0 = len(step_ms)
            zero_counts(mods)
            summ = train_pgd.main(argv + ['--max-steps', str(max_steps)]
                                  + (['--resume'] if i else []))
            if any(counts(mods).values()):
                fail(f'stage 4: train_pgd run {i + 1} launched a kernel: '
                     f'{counts(mods)}')
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in step_ms[n0:]]
            summ.update(step_device_ms=ms,
                        peak_bytes=torch.cuda.max_memory_allocated())
            summ['images_per_s_events'] = (
                batch * (len(ms) - 1) / (sum(ms[1:]) / 1e3)
                if len(ms) > 1 else None)
            # the rate the steps reached, at 3 forwards' FLOPs an image
            summ['tflop_per_s_events'] = (
                None if summ['images_per_s_events'] is None else
                3 * res['forward_flop'] * summ['images_per_s_events'] / 1e12)
            runs.append(summ)
            print(f'{card}: stage 4 train_pgd run {i + 1}: steps '
                  f'{summ["start_step"]}-{summ["end_step"]} at B={batch} '
                  f'({arch}, f32): after the first step '
                  f'{summ["images_per_s"]:.3f} images/s with the loader '
                  f'(loader wait {100 * summ["loader_wait_share"]:.1f} % '
                  f'of the wall time), '
                  + ('' if summ['images_per_s_events'] is None else
                     f'{summ["images_per_s_events"]:.3f} by CUDA events '
                     f'around the steps '
                     f'({summ["tflop_per_s_events"]:.2f} TFLOP/s), ')
                  + f'step device ms {[round(v, 1) for v in ms]}; peak '
                  f'memory {summ["peak_bytes"] / 2 ** 30:.2f} GiB')
    finally:
        apis.pgd_train_step = real_step
    first, resumed = runs
    if (first['start_step'], first['end_step']) != (0, S4_STEPS[0]):
        fail(f'stage 4: the first run took steps {first["start_step"]}-'
             f'{first["end_step"]}')
    if (resumed['start_step'], resumed['end_step']) != S4_STEPS:
        fail(f'stage 4: the resume ran steps {resumed["start_step"]}-'
             f'{resumed["end_step"]}, expected {S4_STEPS[0]}-{S4_STEPS[1]}')
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json_.loads(ln) for ln in f]
    if [ln['step'] for ln in lines] != list(range(1, S4_STEPS[1] + 1)):
        fail(f'stage 4: logged steps {[ln["step"] for ln in lines]}')
    o = cfg.optimizer
    sched = step_schedule(o.lr, len(infos) // batch, o.warmup_iters,
                          o.warmup_ratio, o.lr_steps, o.lr_gamma)
    for ln in lines:
        bad = [k for k, v in ln.items()
               if k.startswith('loss') and not np.isfinite(v)]
        if bad or not ln['num_pos'] > 0:
            fail(f'stage 4: step {ln["step"]}: non-finite {bad}, num_pos '
                 f'{ln["num_pos"]}')
        want = sched(ln['step'] - 1)
        if not abs(ln['lr'] - want) <= 1e-12 * want:
            fail(f'stage 4: step {ln["step"]} ran at lr {ln["lr"]}, the '
                 f'schedule gives {want}')
    res.update(train=runs, losses=[ln['loss'] for ln in lines],
               num_pos=[ln['num_pos'] for ln in lines],
               grad_norms=[ln['grad_norm'] for ln in lines],
               lrs=[ln['lr'] for ln in lines])
    print(f'stage 4: losses {[f"{v:.5g}" for v in res["losses"]]}, num_pos '
          f'{res["num_pos"]}, grad norms '
          f'{[f"{v:.4g}" for v in res["grad_norms"]]}, lr '
          f'{[f"{v:.4g}" for v in res["lrs"]]}')
    print(f'{card}: stage 4 checkpoints: '
          f'{first["ckpt_bytes"] / 2 ** 20:.1f} MiB each, save ms '
          f'{[round(v, 1) for v in first["ckpt_save_ms"] + resumed["ckpt_save_ms"]]}'
          f', load (resume) {resumed["ckpt_load_ms"]:.1f} ms')

    # what training moved, from the seeded weights the CLI started from
    trainer = trainers[-1]
    init = apis.init_pgd_detector(model_cfg, device=DEVICE,
                                  seed=cfg.get('seed', 0)).model.state_dict()
    now = trainer.model.state_dict()
    names = dict(trainer.model.named_parameters())
    stuck = [k for k in names if torch.equal(now[k], init[k])]
    bn = [k for k in now if k.endswith(('running_mean', 'running_var'))]
    bn_stuck = [k for k in bn if torch.equal(now[k], init[k])]
    if stuck or bn_stuck:
        fail(f'stage 4: {len(stuck)} parameter tensors and {len(bn_stuck)} '
             f'BN statistics did not move: {(stuck + bn_stuck)[:8]}')
    del init
    print(f'stage 4: all {len(names)} parameter tensors and {len(bn)} BN '
          'statistics moved')

    # decode from the newest checkpoint against the in-memory weights
    ckpt_dir = resumed['ckpt_dir']
    if ckpt.latest_step(ckpt_dir) != S4_STEPS[1]:
        fail(f'stage 4: newest checkpoint {ckpt.latest_step(ckpt_dir)}')
    dataset = KittiMonoDataset(data, pkl)
    images = np.stack([dataset[j]['image'] for j in range(S4_EVAL_BATCH)])
    cam2img = np.stack([dataset[j]['cam2img'] for j in range(S4_EVAL_BATCH)])
    live = apis.infer_mono(apis.DetectorBundle(trainer.model, model_cfg,
                                               torch.device(DEVICE)),
                           images, cam2img)
    bundle = apis.init_pgd_detector(model_cfg, ckpt.load_variables(ckpt_dir),
                                    device=DEVICE)
    loaded = apis.infer_mono(bundle, images, cam2img)
    for key, v in live.items():
        if not torch.equal(v, loaded[key]):
            fail(f'stage 4: decode {key} from step_{S4_STEPS[1]}.pt differs '
                 'from the in-memory weights')
    # the head's outputs too: four steps from random weights may leave
    # every score under the decode's threshold
    with torch.no_grad():
        x = torch.as_tensor(images, device=DEVICE).permute(0, 3, 1, 2)
        heads = [m.eval()(x.contiguous())[0]
                 for m in (trainer.model, bundle.model)]
    for lvl, (a, b) in enumerate(zip(*heads)):
        for key in a:
            if not torch.equal(a[key], b[key]):
                fail(f'stage 4: level {lvl} {key} from step_{S4_STEPS[1]}'
                     '.pt differs from the in-memory weights')
    print(f'stage 4: the head outputs and decode of {S4_EVAL_BATCH} images '
          f'from step_{S4_STEPS[1]}.pt equal the in-memory weights\' '
          f'({int(live["valid"].sum())} kept boxes, top kept score '
          f'{float(live["scores"].max()):.4g})')
    del trainer, trainers, live, loaded, heads, x

    zero_counts(mods)
    ev = tools_lib.evaluate_mono(bundle, dataset, batch_size=S4_EVAL_BATCH)
    if any(counts(mods).values()):
        fail(f'stage 4: evaluate_mono launched a kernel: {counts(mods)}')
    missing = [k for k in tools_lib.MONO_AP_KEYS if k not in ev]
    if missing:
        fail(f'stage 4: evaluate_mono gave no {missing}')
    ev['images_per_s'] = ev['images'] / ev['infer_s']
    print(f'{card}: stage 4 evaluate_mono on {ev["images"]} images: '
          f'inference {ev["images_per_s"]:.2f} images/s (batches of '
          f'{S4_EVAL_BATCH}, host clock, the decode\'s copy to the host '
          f'included), {ev["detections"]} detections; '
          + ', '.join(f'{k} {ev[k]:.4g}' for k in tools_lib.MONO_AP_KEYS))
    res['eval'] = ev
    return res


# --- the indoor retrain: FCAF3D on SUN RGB-D through the port's CLI -------
IN_CONFIG = 'configs/gga/gga_sunrgbd.py'
IN_SCENES = 16              # scenes of the mini SUN RGB-D
IN_POINTS = 50000           # xyzrgb points a scene
IN_STEPS = (4, 6)           # --max-steps of the first run, of the resume
IN_OPTIONS = ('log_interval=1',)
IN_EVAL_SCENES = 8          # scenes of infer_indoor + indoor_eval
# (dx, dy, dz) of each SUN RGB-D class, metres
IN_CLASS_DIMS = ((2.0, 1.6, 0.6), (1.4, 0.8, 0.75), (2.0, 0.9, 0.85),
                 (0.55, 0.55, 0.9), (0.45, 0.7, 0.75), (1.3, 0.65, 0.75),
                 (1.0, 0.5, 1.1), (0.5, 0.45, 0.6), (1.0, 0.35, 1.8),
                 (1.6, 0.8, 0.55))


def mini_indoor_scene(rng, n_points, floor_z=-1.2):
    """One SUN RGB-D-like room in the depth frame (z up): a floor, two
    walls and 4-8 upright boxes of the 10 classes inside +-6 m x +-2.5 m,
    points spread over the visible surfaces with a colour per surface.
    Returns (points [n, 6] f32 xyzrgb, boxes [m, 7] gravity-centered
    (x, y, z, dx, dy, dz, yaw), labels [m])."""
    n_obj = rng.randint(4, 9)
    labels = rng.randint(0, 10, n_obj)
    dims = np.asarray(IN_CLASS_DIMS)[labels] * rng.uniform(0.85, 1.15,
                                                           (n_obj, 3))
    xy = np.stack([rng.uniform(-5.0, 5.0, n_obj),
                   rng.uniform(-1.8, 1.8, n_obj)], -1)
    yaw = rng.uniform(-np.pi, np.pi, n_obj)
    boxes = np.concatenate([xy, floor_z + dims[:, 2:3] / 2, dims,
                            yaw[:, None]], -1).astype(np.float32)
    n_box = n_points * 2 // 5 // n_obj
    n_bg = n_points - n_box * n_obj
    parts = []
    # the floor and two walls (y = 2.5 behind, x = -6 at the side)
    n_f, n_w = n_bg // 2, n_bg - n_bg // 2
    floor = np.stack([rng.uniform(-6, 6, n_f), rng.uniform(-2.5, 2.5, n_f),
                      np.full(n_f, floor_z)], -1)
    back = np.stack([rng.uniform(-6, 6, n_w // 2), np.full(n_w // 2, 2.5),
                     rng.uniform(floor_z, 1.3, n_w // 2)], -1)
    side = np.stack([np.full(n_w - n_w // 2, -6.0),
                     rng.uniform(-2.5, 2.5, n_w - n_w // 2),
                     rng.uniform(floor_z, 1.3, n_w - n_w // 2)], -1)
    for pts, rgb in ((floor, (0.45, 0.35, 0.25)), (back, (0.85, 0.85, 0.8)),
                     (side, (0.8, 0.8, 0.75))):
        parts.append(np.concatenate([pts, np.broadcast_to(rgb, pts.shape)],
                                    -1))
    for box, label in zip(boxes, labels):
        # the top and the four sides, by area
        dx, dy, dz = box[3:6]
        areas = np.array([dx * dy, dx * dz, dx * dz, dy * dz, dy * dz])
        face = rng.choice(5, n_box, p=areas / areas.sum())
        u, v = rng.uniform(-0.5, 0.5, (2, n_box))
        local = np.zeros((n_box, 3))
        local[:, 0] = np.select([face == 3, face == 4], [-0.5, 0.5], u) * dx
        local[:, 1] = np.select([face == 1, face == 2, face >= 3],
                                [-0.5, 0.5, u], v) * dy
        local[:, 2] = np.where(face == 0, 0.5, v) * dz
        c, s = np.cos(box[6]), np.sin(box[6])
        world = np.stack([local[:, 0] * c - local[:, 1] * s + box[0],
                          local[:, 0] * s + local[:, 1] * c + box[1],
                          local[:, 2] + box[2]], -1)
        rgb = 0.2 + 0.6 * np.asarray([label % 3, label % 5, label % 7]) / [
            2, 4, 6]
        parts.append(np.concatenate(
            [world, np.clip(rgb + rng.randn(n_box, 3) * 0.05, 0, 1)], -1))
    points = np.concatenate(parts)
    points[:, :3] += rng.randn(len(points), 3) * 0.005
    return points.astype(np.float32), boxes, labels


def write_mini_sunrgbd(root, n_scenes=IN_SCENES, n_points=IN_POINTS,
                       seed=0):
    """A SUN RGB-D-format dataset under ``root``: points/{idx:06d}.bin
    (xyzrgb f32) and sunrgbd_infos.pkl, mmdet3d's info layout (pts_path,
    annos with gt_num, gt_boxes_upright_depth, class, name). Returns the
    pkl's path."""
    import os
    import pickle
    from gga_tpu_torch.data.sunrgbd import CLASSES
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, 'points'), exist_ok=True)
    infos = []
    for idx in range(n_scenes):
        pts, boxes, labels = mini_indoor_scene(rng, n_points)
        path = os.path.join('points', f'{idx:06d}.bin')
        pts.tofile(os.path.join(root, path))
        infos.append(dict(
            point_cloud=dict(num_features=6, lidar_idx=idx), pts_path=path,
            annos=dict(gt_num=len(boxes), gt_boxes_upright_depth=boxes,
                       **{'class': labels.astype(np.int64)},
                       name=np.asarray([CLASSES[i] for i in labels]))))
    pkl = os.path.join(root, 'sunrgbd_infos.pkl')
    with open(pkl, 'wb') as f:
        pickle.dump(infos, f)
    return pkl


# gather_gemm_conv launches of one FCAF3D forward: conv1 and the four
# strided blocks' convs (rulebooks), 28 SubM convs of MinkResNet34's 16
# blocks, 4 out blocks and 3 up blocks of the head; a train step adds the
# input gradient of all but conv1 (whose input, the colours, needs none)
# and the weight gradient of all 40
IN_CONVS, IN_DGRAD = 40, 39
IN_PER_STEP = dict(gather_gemm_conv=IN_CONVS + IN_DGRAD,
                   gather_gemm_dw=IN_CONVS, gather_rows=0, gather_rows_t=0,
                   render_heatmap=0)


def bits_equal(torch, a, b):
    """The same bits: a NaN in the same place counts as equal (an f32 is
    compared as its int32 bits)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def non_finite(torch, tensors):
    """Entries of the float tensors that are not finite."""
    return sum(int((~torch.isfinite(t)).sum()) for t in tensors
               if t.is_floating_point())


def indoor_batch(dataset, idx):
    """The items ``idx`` of a SunRgbdDataset, stacked."""
    items = [dataset[i] for i in idx]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def indoor_levels(torch, model, batch):
    """One eval-mode forward's backbone outputs and head outputs."""
    captured = []
    real = model.backbone.forward

    def keep(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    model.backbone.forward = keep
    try:
        with torch.no_grad():
            outs = model.eval()(*(torch.as_tensor(batch[k], device=DEVICE)
                                  for k in ('points', 'colors',
                                            'points_valid')))
    finally:
        del model.backbone.forward
    return captured[0], outs


def indoor_plain_comparison(torch, mods, model, batch):
    """One eval-mode forward with the kernels vs the plain versions: each
    backbone level's features within the f32 forward gate of max|plain|
    (no prune before them); at each head level, after its prune, the same
    kept sites, then center / bbox / cls within the gate."""
    gate = GATES['float32']['forward']
    bb_k, heads_k = indoor_levels(torch, model, batch)
    with plain_versions(wrappers(mods)):
        bb_p, heads_p = indoor_levels(torch, model, batch)
    res = {}
    for lvl, (a, b) in enumerate(zip(bb_k, bb_p)):
        if not (torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])):
            fail(f'indoor plain comparison: backbone level {lvl} sites '
                 'differ')
        ok, err = within_tolerance(torch, a[0], b[0], gate)
        res[f'backbone{lvl}'] = dict(max_abs_err=err, max_abs_plain=float(
            b[0].abs().max()))
        if not ok:
            fail(f'indoor plain comparison: backbone level {lvl} differs, '
                 f'max abs err {err}')
    for lvl, (a, b) in enumerate(zip(heads_k, heads_p)):
        if not (torch.equal(a['valid'], b['valid'])
                and torch.equal(a['points'], b['points'])):
            fail(f'indoor plain comparison: head level {lvl} kept other '
                 'sites after its prune')
        for key in ('center', 'bbox', 'cls'):
            v = a['valid']
            ok, err = within_tolerance(torch, a[key][v], b[key][v], gate)
            res[f'head{lvl}.{key}'] = dict(
                max_abs_err=err, max_abs_plain=float(b[key][v].abs().max()))
            if not ok:
                fail(f'indoor plain comparison: head level {lvl} {key} '
                     f'differs, max abs err {err}')
    return res


def indoor_phase(torch, mods, card, tmp):
    """The indoor GGA retrain on a mini SUN RGB-D written to ``tmp``:
    FCAF3D as shipped (configs/gga/gga_sunrgbd.py: MinkResNet34 + head,
    f32, B = 2 x 20 000 points, voxel 0.01 m).

    1. One recorded train step of a seeded trainer: every gather_gemm_conv
       (40 forward, 39 input gradients) and gather_gemm_dw (40) call is
       replayed against its plain version within the f32 gates and timed;
       one eval-mode forward with the kernels against the plain versions
       (``indoor_plain_comparison``).
    2. Main path: ``train_fcaf3d`` for IN_STEPS[0] steps, then
       ``--resume`` to IN_STEPS[1]; the counts are set to 0 just before
       each run and read just after (79 / 40 launches a step, nothing
       else); CUDA events around each step; active sites at each budget.
    3. Gates: finite losses with positives at every step, each step's lr,
       the resume, every parameter and BN statistic moved, the head
       outputs and decode from the newest checkpoint equal to the
       in-memory weights'.
    4. ``infer_indoor`` + ``indoor_eval`` on IN_EVAL_SCENES scenes (40
       launches a forward)."""
    import json as json_
    import os

    from gga_tpu_torch import apis, tools_lib
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.sunrgbd import CLASSES, SunRgbdDataset
    from gga_tpu_torch.eval.indoor_eval import indoor_eval
    from gga_tpu_torch.ops import sparse as sp
    from gga_tpu_torch.tools import train_fcaf3d
    from gga_tpu_torch.train import checkpoints as ckpt
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    sparse_conv = mods[0]

    root = os.path.join(tmp, 'sunrgbd')
    pkl = write_mini_sunrgbd(root, IN_SCENES, IN_POINTS)
    config = str(ROOT / IN_CONFIG)
    cfg = Config.fromfile(config)
    batch = cfg.data.samples_per_gpu
    model_cfg = tools_lib.model_config_from_cfg(cfg)
    head = model_cfg.head
    print(f'indoor: mini SUN RGB-D of {IN_SCENES} scenes x {IN_POINTS} '
          f'points; FCAF3D MinkResNet{model_cfg.depth}, voxel '
          f'{model_cfg.voxel_size} m, grid {model_cfg.grid_zyx}, B = '
          f'{batch} x {cfg.data.num_points} points, f32')
    res = {}

    # --- 1. one recorded step: every kernel call against its plain version
    dataset = SunRgbdDataset(root, pkl, num_points=cfg.data.num_points,
                             max_objs=head.max_objs)
    b0 = indoor_batch(dataset, range(batch))
    trainer = apis.init_fcaf3d_trainer(model_cfg, 1, device=DEVICE,
                                       seed=cfg.get('seed', 0))
    with recording(sparse_conv, 'gather_gemm_conv') as conv_calls, \
            recording(sparse_conv, 'gather_gemm_dw') as dw_calls:
        logs0 = apis.fcaf3d_train_step(trainer, b0)
    torch.cuda.synchronize()
    finite_logs(torch, logs0, 'indoor recorded step')
    if (len(conv_calls), len(dw_calls)) != (IN_CONVS + IN_DGRAD, IN_CONVS):
        fail(f'indoor recorded step: {len(conv_calls)} gather_gemm_conv and '
             f'{len(dw_calls)} gather_gemm_dw calls, expected '
             f'{IN_CONVS + IN_DGRAD} and {IN_CONVS}')
    torch.set_grad_enabled(False)
    conv_rows = [conv_row(torch, sparse_conv, *a, f'indoor call {i}')
                 for i, (_, a) in enumerate(conv_calls)]
    del conv_calls
    print_conv_rows(f'indoor kernels: gather_gemm_conv f32 vs plain at the '
                    f'step\'s {IN_CONVS} forward calls', conv_rows[:IN_CONVS])
    print_conv_rows(f'indoor kernels: gather_gemm_conv f32 vs plain at the '
                    f'step\'s {IN_DGRAD} input-gradient calls',
                    conv_rows[IN_CONVS:])
    dwr = dw_rows(torch, sparse_conv, dw_calls, 'indoor kernels')
    del dw_calls
    res['plain_comparison'] = indoor_plain_comparison(
        torch, mods, trainer.model, b0)
    torch.set_grad_enabled(True)
    worst = max(res['plain_comparison'].items(),
                key=lambda kv: kv[1]['max_abs_err'] / max(
                    kv[1]['max_abs_plain'], 1e-30))
    print(f'indoor kernel vs plain forward: backbone levels and head '
          f'levels\' outputs within {GATES["float32"]["forward"]} of '
          f'max|plain|, the same kept sites; worst {worst[0]} err '
          f'{worst[1]["max_abs_err"]:.4g} (max {worst[1]["max_abs_plain"]:.4g})')
    # conv1's dilation: its output sites before the budget cuts them
    feats, coords, valid = trainer.model.voxelize(*(
        torch.as_tensor(b0[k], device=DEVICE)
        for k in ('points', 'colors', 'points_valid')))
    big = 8 * coords.shape[1]
    cand = sp.downsample_coords(sp.SparseTensor(feats, coords, valid,
                                                model_cfg.grid_zyx),
                                3, 2, 1, big)[1].sum(-1)
    res['conv1_sites_before_budget'] = cand.tolist()
    del trainer, feats, coords, valid, cand
    torch.cuda.empty_cache()

    # --- 2. the main path: the CLI, then a resume --------------------------
    work = os.path.join(tmp, 'work_fcaf3d')
    argv = [config, '--info', pkl, '--data-root', root, '--work-dir', work,
            '--device', DEVICE, '--cfg-options', *IN_OPTIONS]
    trainers, step_ms, diags = [], [], []
    real_step = apis.fcaf3d_train_step

    def timed_step(trainer, b):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        diag = {}
        start.record()
        logs = real_step(trainer, b, diag)
        end.record()
        trainers.append(trainer)
        step_ms.append((start, end))
        diags.append(diag)
        return logs

    runs = []
    apis.fcaf3d_train_step = timed_step
    try:
        for i, max_steps in enumerate(IN_STEPS):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            n0 = len(step_ms)
            zero_counts(mods)
            summ = train_fcaf3d.main(argv + ['--max-steps', str(max_steps)]
                                     + (['--resume'] if i else []))
            got = counts(mods)
            n = summ['steps']
            want = {k: v * n for k, v in IN_PER_STEP.items()}
            if got != want:
                fail(f'indoor: train_fcaf3d run {i + 1} launched {got} in '
                     f'{n} steps, expected {want}')
            torch.cuda.synchronize()
            ms = [a.elapsed_time(b) for a, b in step_ms[n0:]]
            summ.update(step_device_ms=ms, launches=got,
                        peak_bytes=torch.cuda.max_memory_allocated())
            summ['scenes_per_s_events'] = (
                batch * (len(ms) - 1) / (sum(ms[1:]) / 1e3)
                if len(ms) > 1 else None)
            runs.append(summ)
            print(f'{card}: indoor train_fcaf3d run {i + 1}: steps '
                  f'{summ["start_step"]}-{summ["end_step"]} at B={batch} '
                  f'(f32): after the first step {summ["scenes_per_s"]:.3f} '
                  f'scenes/s with the loader (loader wait '
                  f'{100 * summ["loader_wait_share"]:.1f} % of the wall '
                  'time), '
                  + ('' if summ['scenes_per_s_events'] is None else
                     f'{summ["scenes_per_s_events"]:.3f} by CUDA events '
                     'around the steps, ')
                  + f'step device ms {[round(v, 1) for v in ms]}; peak '
                  f'memory {summ["peak_bytes"] / 2 ** 30:.2f} GiB; launches '
                  f'{got}')
    finally:
        apis.fcaf3d_train_step = real_step
    first, resumed = runs
    if (first['start_step'], first['end_step']) != (0, IN_STEPS[0]):
        fail(f'indoor: the first run took steps {first["start_step"]}-'
             f'{first["end_step"]}')
    if (resumed['start_step'], resumed['end_step']) != IN_STEPS:
        fail(f'indoor: the resume ran steps {resumed["start_step"]}-'
             f'{resumed["end_step"]}, expected {IN_STEPS[0]}-{IN_STEPS[1]}')

    # active sites a scene at every budget, mean over the CLI's steps
    budgets = dict(voxels=model_cfg.max_voxels)
    for name, bud in zip(('conv1', 'pool', 'layer1', 'layer2', 'layer3',
                          'layer4'), model_cfg.backbone_budgets):
        budgets[name] = bud
    for i, bud in enumerate(head.level_budgets):
        budgets[f'head{i}'] = bud
    active = {k: float(np.mean([d[f'active.{k}'].float().mean().item()
                                for d in diags])) for k in budgets}
    res['active'] = {k: dict(active=active[k], budget=budgets[k])
                     for k in budgets}
    print(f'{card}: indoor active sites a scene / budget (mean over the '
          f'{len(diags)} CLI steps): ' + ', '.join(
              f'{k} {active[k]:.0f}/{budgets[k]}' for k in budgets)
          + f'; conv1 before its budget '
          f'{res["conv1_sites_before_budget"]} (recorded batch)')

    # --- 3. gates on what the CLI did --------------------------------------
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json_.loads(ln) for ln in f]
    if [ln['step'] for ln in lines] != list(range(1, IN_STEPS[1] + 1)):
        fail(f'indoor: logged steps {[ln["step"] for ln in lines]}')
    o = cfg.optimizer
    sched = piecewise_constant_schedule(
        o.lr, {first['steps_per_epoch'] * e: o.lr_gamma for e in o.lr_steps})
    for ln in lines:
        bad = [k for k, v in ln.items()
               if k.endswith('loss') and not np.isfinite(v)]
        if bad or not ln['num_pos'] > 0:
            fail(f'indoor: step {ln["step"]}: non-finite {bad}, num_pos '
                 f'{ln["num_pos"]}')
        want = sched(ln['step'] - 1)
        if not abs(ln['lr'] - want) <= 1e-12 * want:
            fail(f'indoor: step {ln["step"]} ran at lr {ln["lr"]}, the '
                 f'schedule gives {want}')
    res.update(train=runs, losses=[ln['loss'] for ln in lines],
               num_pos=[ln['num_pos'] for ln in lines],
               grad_norms=[ln['grad_norm'] for ln in lines],
               lrs=[ln['lr'] for ln in lines])
    print(f'indoor: losses {[f"{v:.5g}" for v in res["losses"]]}, num_pos '
          f'{res["num_pos"]}, grad norms '
          f'{[f"{v:.4g}" for v in res["grad_norms"]]}, lr '
          f'{[f"{v:.4g}" for v in res["lrs"]]}')
    print(f'{card}: indoor checkpoints: '
          f'{first["ckpt_bytes"] / 2 ** 20:.1f} MiB each, save ms '
          f'{[round(v, 1) for v in first["ckpt_save_ms"] + resumed["ckpt_save_ms"]]}'
          f', load (resume) {resumed["ckpt_load_ms"]:.1f} ms')

    trainer = trainers[-1]
    init = apis.init_fcaf3d_detector(model_cfg, device=DEVICE,
                                     seed=cfg.get('seed', 0)).model
    init = init.state_dict()
    now = trainer.model.state_dict()
    names = dict(trainer.model.named_parameters())
    stuck = [k for k in names if torch.equal(now[k], init[k])]
    bn = [k for k in now if k.endswith(('running_mean', 'running_var'))]
    bn_stuck = [k for k in bn if torch.equal(now[k], init[k])]
    if stuck or bn_stuck:
        fail(f'indoor: {len(stuck)} parameter tensors and {len(bn_stuck)} '
             f'BN statistics did not move: {(stuck + bn_stuck)[:8]}')
    del init
    print(f'indoor: all {len(names)} parameter tensors and {len(bn)} BN '
          'statistics moved')

    ckpt_dir = resumed['ckpt_dir']
    if ckpt.latest_step(ckpt_dir) != IN_STEPS[1]:
        fail(f'indoor: newest checkpoint {ckpt.latest_step(ckpt_dir)}')
    test_set = SunRgbdDataset(root, pkl, num_points=cfg.data.num_points,
                              max_objs=head.max_objs, test_mode=True)
    b1 = indoor_batch(test_set, range(batch))
    inputs = [b1[k] for k in ('points', 'colors', 'points_valid')]
    live = apis.infer_indoor(apis.DetectorBundle(trainer.model, model_cfg,
                                                 torch.device(DEVICE)),
                             *inputs)
    bundle = apis.init_fcaf3d_detector(model_cfg,
                                       ckpt.load_variables(ckpt_dir),
                                       device=DEVICE)
    loaded = apis.infer_indoor(bundle, *inputs)
    for key, v in live.items():
        if not bits_equal(torch, v, loaded[key]):
            fail(f'indoor: decode {key} from step_{IN_STEPS[1]}.pt differs '
                 f'from the in-memory weights at {int((v != loaded[key]).sum())}'
                 f' of {v.numel()} entries, max abs difference '
                 f'{float((v.float() - loaded[key].float()).abs().max())}')
    heads = [indoor_levels(torch, m, b1)[1] for m in (trainer.model,
                                                      bundle.model)]
    for lvl, (a, b) in enumerate(zip(*heads)):
        for key in a:
            if not bits_equal(torch, a[key], b[key]):
                fail(f'indoor: level {lvl} {key} from step_{IN_STEPS[1]}'
                     '.pt differs from the in-memory weights')
    res['non_finite'] = dict(
        head=non_finite(torch, [o[k] for o in heads[0] for k in o]),
        decode=non_finite(torch, [live['boxes'][live['valid']],
                                  live['scores'][live['valid']]]))
    print(f'indoor: the head outputs and decode of {batch} scenes from '
          f'step_{IN_STEPS[1]}.pt equal the in-memory weights\' bit for bit '
          f'({int(live["valid"].sum())} kept boxes, top kept score '
          f'{float(live["scores"].max()):.4g}; non-finite entries: '
          f'{res["non_finite"]["head"]} in the head outputs, '
          f'{res["non_finite"]["decode"]} in the kept boxes and scores)')
    del trainer, trainers, live, loaded, heads

    # --- 4. inference and the indoor eval ----------------------------------
    gts, dts, infer_s = [], [], 0.0
    zero_counts(mods)
    for i in range(0, IN_EVAL_SCENES, batch):
        bt = indoor_batch(test_set, range(i, i + batch))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = apis.infer_indoor(bundle, bt['points'], bt['colors'],
                              bt['points_valid'])
        d = {k: v.cpu().numpy() for k, v in d.items()}
        infer_s += time.perf_counter() - t0
        for j in range(batch):
            v = d['valid'][j]
            dts.append(dict(boxes=d['boxes'][j][v], labels=d['labels'][j][v],
                            scores=d['scores'][j][v]))
            ov = bt['obj_valid'][j]
            gts.append(dict(gt_boxes=bt['gt_boxes'][j][ov],
                            labels=bt['gt_labels'][j][ov]))
    got = counts(mods)
    want = dict(IN_PER_STEP, gather_gemm_conv=IN_CONVS * IN_EVAL_SCENES
                // batch, gather_gemm_dw=0)
    if got != want:
        fail(f'indoor: infer_indoor launched {got}, expected {want}')
    _, ap = indoor_eval(gts, dts, classes=CLASSES)
    missing = [k for k in ('mAP_0.25', 'mAP_0.50') if k not in ap]
    if missing:
        fail(f'indoor: indoor_eval gave no {missing}')
    res['eval'] = dict(scenes=IN_EVAL_SCENES, infer_s=infer_s,
                       scenes_per_s=IN_EVAL_SCENES / infer_s,
                       detections=sum(len(d['scores']) for d in dts),
                       launches=got, ap=ap)
    print(f'{card}: indoor infer_indoor + indoor_eval on {IN_EVAL_SCENES} '
          f'scenes: inference {res["eval"]["scenes_per_s"]:.2f} scenes/s '
          f'(batches of {batch}, host clock, decode, NMS and the copy to '
          f'the host included), {res["eval"]["detections"]} detections; '
          f'mAP_0.25 {ap["mAP_0.25"]:.4g}, mAP_0.50 {ap["mAP_0.50"]:.4g}')
    res.update(conv_calls=conv_rows, dw_calls=dwr)
    return res


def scene_points(torch, dev, seed):
    """(points, valid) of one bench-point batch on ``dev``."""
    b = make_batch(B, P, M_OBJ, PC, seed)
    return (torch.from_numpy(b['points']).to(dev),
            torch.from_numpy(b['points_valid']).to(dev))


def train_batch(torch, dev, seed):
    """One bench-point train batch on ``dev``."""
    return {k: torch.from_numpy(v).to(dev)
            for k, v in make_batch(B, P, M_OBJ, PC, seed).items()}


def train_kernel_rows(torch, sparse_conv, rec, label):
    """The recorded step's gather_gemm_conv calls (forward, then the
    submanifold input gradients) and gather_gemm_dw calls, replayed
    against their plain versions and timed."""
    conv_calls = rec['gather_gemm_conv']
    fwd_calls = [a for ph, a in conv_calls if ph == 'forward']
    dgrad_calls = [a for ph, a in conv_calls if ph == 'backward']
    if (len(fwd_calls), len(dgrad_calls)) != (N_CONVS, N_DGRAD):
        fail(f'{label}: {len(fwd_calls)} forward and {len(dgrad_calls)} '
             f'input-gradient convs, expected {N_CONVS} and {N_DGRAD}')
    conv_rows = [conv_row(torch, sparse_conv, *a, f'{label} call {i}')
                 for i, a in enumerate(fwd_calls + dgrad_calls)]
    print_conv_rows(f'{label}: gather_gemm_conv vs plain at the step\'s '
                    f'{N_CONVS} forward calls', conv_rows[:N_CONVS])
    print_conv_rows(f'{label}: gather_gemm_conv vs plain at the step\'s '
                    f'{N_DGRAD} submanifold input-gradient calls',
                    conv_rows[N_CONVS:])
    dwr = dw_rows(torch, sparse_conv, rec['gather_gemm_dw'], label)
    return conv_rows, dwr, fwd_calls


def print_step_comparison(label, cmp_step):
    print(f'{label}: loss {cmp_step["loss_kernel"]:.8g} vs '
          f'{cmp_step["loss_plain"]:.8g} (rel {cmp_step["loss_rel"]:.3g}),'
          f' grad norm {cmp_step["grad_norm_kernel"]:.8g} vs '
          f'{cmp_step["grad_norm_plain"]:.8g} (rel '
          f'{cmp_step["grad_norm_rel"]:.3g}; plain step, one ulp of input '
          f'noise: {cmp_step["grad_norm_rel_plain_ulp_noise"]:.3g}), min '
          f'cosine of the {N_CONVS} sparse conv weight gradients '
          f'{cmp_step["min_cosine"]:.8f} (plain step, one ulp of input '
          f'noise: {cmp_step["min_cosine_plain_ulp_noise"]:.8f}); batch-norm '
          f'updates of {cmp_step["bn_buffers"]} buffers within '
          f'{cmp_step["bn_update_max_rel_err"]:.3g} of their largest entry')


def f32_phase(torch, apis, sp, mods, card):
    """The f32 sparse-conv kernels at the bench point: the bench's
    configuration in f32 (the shipped configs' dtype), B=8, P=20 000,
    M=500, Pc=256. One stage-3 forward's 21 gather_gemm_conv calls and one
    train step's 37 gather_gemm_conv and 21 gather_gemm_dw calls are
    replayed against their plain f32 versions (TF32 off) and timed; stage
    3 and the train step run as the main path with exact launch counts
    and their rates; the forward and one step with the kernels are held
    against the same with the plain versions."""
    sparse_conv = mods[0]
    cfg, tcfg = configs('float32')
    bundle = apis.init_detector(cfg, device=DEVICE, seed=0)
    dev = bundle.device
    rows = kernel_phase(torch, sparse_conv, bundle, *scene_points(torch, dev, 0),
                        N_CONVS, label='f32 kernel phase')
    batches = [scene_points(torch, dev, s) for s in range(1, 5)]
    sl = slice_phase(torch, sparse_conv, apis, bundle, batches, N_CONVS,
                     label='f32 slice phase')
    print(f'{card}: f32 stage 3: {sl["forwards"]} x {B} scenes in '
          f'{sl["ms"]:.2f} ms = {sl["scenes_per_s"]:.2f} scenes/s; '
          f'{sl["launches"]} kernel launches; {sl["valid_detections"]} '
          'valid detections')
    stages = breakdown(torch, bundle, batches[1:])
    print('f32 breakdown (device ms per batch of 8): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    cmp = plain_comparison(torch, mods, bundle, *batches[1])
    print('f32 kernel vs plain forward: ' + ', '.join(
        f'{k} err {v["max_abs_err"]:.4g} (max {v["max_abs_plain"]:.4g})'
        for k, v in cmp.items()))
    del bundle, batches

    trainer = apis.init_trainer(tcfg, total_steps=10000, device=DEVICE,
                                seed=0)
    tbatches = [train_batch(torch, dev, s) for s in range(10, 11 + TRAIN_STEPS)]
    logs0, rec, _ = recorded_step(torch, apis, sp, mods, trainer, tbatches[0])
    finite_logs(torch, logs0, 'f32 warm-up step')
    n_rec = {k: len(v) for k, v in rec.items()}
    if n_rec != PER_STEP:
        fail(f'f32 warm-up step: kernel calls {n_rec}, expected {PER_STEP}')
    tr = train_phase(torch, apis, mods, trainer, tbatches[1:],
                     label='f32 train phase')
    print(f'{card}: f32 train: {tr["steps"]} steps x {B} scenes in '
          f'{tr["ms"]:.2f} ms = {tr["scenes_per_s"]:.2f} scenes/s; launches '
          f'{tr["launches"]}; losses {[round(v, 2) for v in tr["losses"]]}')
    print('f32 train breakdown (device ms per step of 8 scenes): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in tr['breakdown'].items()))
    torch.set_grad_enabled(False)
    conv_rows, dwr, _ = train_kernel_rows(torch, sparse_conv, rec,
                                          'f32 train kernels')
    del rec
    torch.set_grad_enabled(True)
    cmp_step = step_comparison(torch, mods, trainer, tbatches[1])
    print_step_comparison('f32 whole step kernels vs plain', cmp_step)
    return dict(infer_calls=rows, slice=sl, breakdown=stages,
                plain_comparison=cmp, train=tr, train_conv_calls=conv_rows,
                train_dw_calls=dwr, step_comparison=cmp_step)


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False')
    if not (ROOT / 'gga_tpu_torch' / '__init__.py').is_file():
        fail(f'gga_tpu_torch/ not found beside {Path(__file__).name}: run it '
             'from a checkout of the repository')
    sys.path.insert(0, str(ROOT))
    from gga_tpu_torch import apis
    from gga_tpu_torch.kernels import _build
    from gga_tpu_torch.kernels import gather_rows as gr
    from gga_tpu_torch.kernels import heatmap, sparse_conv
    from gga_tpu_torch.ops import sparse as sp
    mods = (sparse_conv, gr, heatmap)

    card = card_line()
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'python {sys.version.split()[0]}')
    t_start = time.perf_counter()

    build_s = _build.build_all(SOURCES)
    for lib in (sparse_conv.build, sparse_conv.build_dw, gr.build,
                heatmap.build):
        lib()
    print('kernel builds (s, all nvcc runs started together): ' + ', '.join(
        f'{k}.cu {v:.1f}' for k, v in build_s.items()))

    # --- stage-3 inference -------------------------------------------------
    cfg, tcfg = configs()
    bundle = apis.init_detector(cfg, device=DEVICE, seed=0)
    dev = bundle.device

    rows = kernel_phase(torch, sparse_conv, bundle,
                        *scene_points(torch, dev, 0), n_convs=N_CONVS)
    batches = [scene_points(torch, dev, s) for s in range(1, 5)]
    sl = slice_phase(torch, sparse_conv, apis, bundle, batches,
                     n_convs=N_CONVS)
    print(f'slice phase: {sl["forwards"]} x {B} scenes in {sl["ms"]:.2f} ms '
          f'= {sl["scenes_per_s"]:.2f} scenes/s; {sl["launches"]} kernel '
          f'launches; {sl["valid_detections"]} valid detections')
    stages = breakdown(torch, bundle, batches[1:])
    print('breakdown (device ms per batch of 8): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in stages.items()))
    prof = device_profile(torch, lambda: apis.infer(bundle, *batches[1]))
    print_profile('infer', prof)
    cmp = plain_comparison(torch, mods, bundle, *batches[1])
    print('kernel vs plain forward: ' + ', '.join(
        f'{k} err {v["max_abs_err"]:.4g} (max {v["max_abs_plain"]:.4g})'
        for k, v in cmp.items()))
    del bundle, batches

    # --- GGA weak training ---------------------------------------------------
    trainer = apis.init_trainer(tcfg, total_steps=10000, device=DEVICE,
                                seed=0)
    tbatches = [train_batch(torch, dev, s) for s in range(10, 11 + TRAIN_STEPS)]
    logs0, rec, strided_maps = recorded_step(torch, apis, sp, mods, trainer,
                                             tbatches[0])
    finite_logs(torch, logs0, 'warm-up step')
    n_rec = {k: len(v) for k, v in rec.items()}
    if n_rec != PER_STEP:
        fail(f'warm-up step: kernel calls {n_rec}, expected {PER_STEP}')
    tr = train_phase(torch, apis, mods, trainer, tbatches[1:])
    print(f'train phase: {tr["steps"]} steps x {B} scenes in {tr["ms"]:.2f} '
          f'ms = {tr["scenes_per_s"]:.2f} scenes/s; launches {tr["launches"]}'
          f'; losses {[round(v, 2) for v in tr["losses"]]}, grad norms '
          f'{[round(v, 1) for v in tr["grad_norms"]]}; '
          f'{tr["params_moved"]} parameter tensors and '
          f'{tr["bn_stats_moved"]} batch-norm buffers moved')
    print('train breakdown (device ms per step of 8 scenes): ' + ', '.join(
        f'{k} {v:.2f}' for k, v in tr['breakdown'].items()))
    print('train logs (last step): ' + ', '.join(
        f'{k} {v:.4g}' for k, v in tr['last_logs'].items()))
    tprof = device_profile(torch, lambda: apis.train_step(trainer,
                                                          tbatches[1]))
    print_profile('train step', tprof)

    # --- the train path's kernels, replayed --------------------------------
    torch.set_grad_enabled(False)
    conv_rows, dwr, fwd_calls = train_kernel_rows(torch, sparse_conv, rec,
                                                  'train kernels')
    gr_rows = rows_rows(torch, gr, [a for _, a in rec['gather_rows']], False)
    strided = [(f, nmap) for f, nmap, _ in fwd_calls
               if any(nmap is m for m in strided_maps)]
    if len(strided) != N_STRIDED:
        fail(f'train kernels: found {len(strided)} strided forward maps, '
             f'expected {N_STRIDED}')
    grt_rows = rows_rows(torch, gr, strided, True)
    hm_rows = heatmap_rows(torch, heatmap, rec['render_heatmap'])
    del rec, fwd_calls, strided
    torch.set_grad_enabled(True)

    cmp_step = step_comparison(torch, mods, trainer, tbatches[1])
    print_step_comparison('whole step kernels vs plain', cmp_step)
    del trainer, tbatches
    torch.cuda.empty_cache()

    # --- the f32 kernels at the bench point --------------------------------
    f32 = f32_phase(torch, apis, sp, mods, card)
    torch.cuda.empty_cache()

    # --- stages 1-3 and the stage-4 export through the command-line tools --
    with tempfile.TemporaryDirectory() as tmp:
        wf = workflow_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- stage 4: the PGD retrain through its CLI, then its eval ---
        s4 = stage4_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- the indoor retrain: FCAF3D through its CLI, then its eval ---
        ind = indoor_phase(torch, mods, card, tmp)

    launches, launches_f32 = tr['launches'], f32['train']['launches']
    kernels = [
        kernel_entry('gather_gemm_conv', 'gather_gemm.cu',
                     'gga_tpu/ops/pallas/window_gather.py:266',
                     launches['gather_gemm_conv'], conv_rows),
        kernel_entry('gather_gemm_dw', 'gather_gemm_dw.cu',
                     'gga_tpu/ops/pallas/window_gather.py:312',
                     launches['gather_gemm_dw'], dwr),
        kernel_entry('gather_gemm_conv_f32', 'gather_gemm.cu',
                     'gga_tpu/ops/pallas/window_gather.py:266',
                     launches_f32['gather_gemm_conv'],
                     f32['train_conv_calls']),
        kernel_entry('gather_gemm_dw_f32', 'gather_gemm_dw.cu',
                     'gga_tpu/ops/pallas/window_gather.py:312',
                     launches_f32['gather_gemm_dw'], f32['train_dw_calls']),
        kernel_entry('gather_rows', 'gather_rows.cu',
                     'gga_tpu/ops/pallas/gather_rows.py:52',
                     launches['gather_rows'], gr_rows,
                     library_ms=sum(r['library_ms'] for r in gr_rows)),
        kernel_entry('gather_rows_t', 'gather_rows.cu',
                     'gga_tpu/ops/pallas/window_gather.py:125',
                     launches['gather_rows_t'], grt_rows),
        kernel_entry('render_heatmap', 'heatmap.cu',
                     'gga_tpu/ops/pallas/heatmap.py:57',
                     launches['render_heatmap'], hm_rows),
    ]
    # the f32 sparse-conv kernels on the indoor path: FCAF3D's step
    ind_launches = {k: sum(r['launches'][k] for r in ind['train'])
                    for k in ('gather_gemm_conv', 'gather_gemm_dw')}
    for entry, key, rows in ((kernels[2], 'gather_gemm_conv',
                              ind['conv_calls']),
                             (kernels[3], 'gather_gemm_dw', ind['dw_calls'])):
        e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                         entry['replaces'],
                         ind_launches[key], rows)
        entry['indoor'] = {k: e[k] for k in (
            'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
            'ffma_bound_ms')}
    print('kernels, summed over the train path\'s calls (ms by CUDA '
          'events, device ms by the profiler, share of the bound):')
    for k in kernels:
        print(f'  {k["name"]:20s} {k["launches"]:4d} launches  ms '
              f'{k["ms"]:.4f}  device {fmt_ms(k["device_ms"])}  bound '
              f'{k["bound_ms"]:.5f}  share {100 * k["bound_share"]:.1f}% / '
              f'{share(k["bound_ms"], k["device_ms"])}  plain '
              f'{k["plain_ms"]:.4f}'
              + ('' if k['ffma_bound_ms'] is None else
                 f'  FFMA bound {k["ffma_bound_ms"]:.5f} (device share '
                 f'{share(k["ffma_bound_ms"], k["device_ms"])})'))
        if 'indoor' in k:
            d = k['indoor']
            print(f'  {"":20s} indoor: {d["launches"]:4d} launches in '
                  f'{sum(r["steps"] for r in ind["train"])} FCAF3D steps; '
                  f'one step: ms {d["ms"]:.4f}  device '
                  f'{fmt_ms(d["device_ms"])}  bound {d["bound_ms"]:.5f}  '
                  f'share {100 * d["bound_share"]:.1f}% / '
                  f'{share(d["bound_ms"], d["device_ms"])}  plain '
                  f'{d["plain_ms"]:.4f}')
    print(f'chip_smoke: {time.perf_counter() - t_start:.1f} s after the '
          'card check')

    out_dir = ROOT / 'chiprun_out'
    out_dir.mkdir(exist_ok=True)
    with open(out_dir / 'chip_smoke.json', 'w') as fh:
        json.dump(dict(card=card, torch=torch.__version__,
                       cuda=torch.version.cuda, build_s=build_s,
                       kernels=kernels, infer_calls=rows, slice=sl,
                       breakdown=stages, profile=prof, plain_comparison=cmp,
                       train=tr, train_profile=tprof,
                       train_conv_calls=conv_rows, train_dw_calls=dwr,
                       train_gather_rows=gr_rows, train_gather_rows_t=grt_rows,
                       train_heatmap=hm_rows, step_comparison=cmp_step,
                       f32=f32, workflow=wf, stage4=s4, indoor=ind),
                  fh, indent=1, default=str)

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
