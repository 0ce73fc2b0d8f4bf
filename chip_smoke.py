#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-3 inference and GGA weak training
paths on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one card

1. Prints the card's name and power limit and the torch/CUDA versions.
2. Builds the four CUDA sources of gga_tpu_torch/kernels/csrc/ (one nvcc
   each for sm_90a, all started at once) and prints each build time.
3. Inference kernel phase: one full-width forward (GGAModelConfig(), bf16,
   B=8 scenes of P=20 000 points, seeded random weights) records the inputs
   of all 21 sparse conv calls; each is replayed through gather_gemm_conv
   and its plain version, |kernel - plain| <= 1e-2 * max|plain| + one bf16
   ulp, and both are timed with CUDA events beside the card's bound (the
   bytes count each distinct source row the call's map hits once).
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
   and plain version (gather_gemm_dw |kernel - plain| <= 1e-4 max|plain|;
   gather_rows and gather_rows_t, the latter on the step's strided maps,
   exactly; render_heatmap |kernel - plain| <= 1e-6 with the same pixels
   at 1.0; the 16 input-gradient convs at the bf16 tolerance of 3.) and
   timed beside the bound and, for gather_rows, index_select.
7. Whole step, kernels vs plain: one step's loss and gradients with every
   kernel and with every plain version, from the same weights, batch and
   SRL draw: loss within 1e-2 relative, grad norm within 5e-2 relative,
   each sparse conv weight gradient at cosine similarity >= 0.99 or, where
   the plain step with a one-ulp perturbation of the encoder input already
   moves that gradient further (the bf16 step is that sensitive at this
   operating point), within twice that distance and never below 0.97;
   each batch-norm statistics update within 1e-2 of its largest entry.
8. Prints one JSON line describing the kernels, the card, then, as the
   last line, {"ok": true, "device": {...}}. Any failed phase exits
   non-zero.

Everything it measures is also written to chiprun_out/chip_smoke.json.
"""
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
B, P = 8, 20000           # bench operating point: scenes x points per scene
M_OBJ, PC = 500, 256      # padded objects per scene, cluster points per object
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, H100 SXM
F32_FLOPS = 67e12          # f32 outside the tensor cores, H100 SXM
SOURCES = ('gather_gemm', 'gather_gemm_dw', 'gather_rows', 'heatmap')
TRAIN_STEPS = 5
DW_RTOL = 1e-4             # gather_gemm_dw vs plain, of max|plain| per call
COSINE_MIN, COSINE_FLOOR = 0.99, 0.97  # whole-step weight-gradient gates
# sparse convs of one full-width forward: 17 submanifold (conv_input + 8
# basic blocks x 2) + 3 strided + conv_out; all but conv_input (whose
# input is the VFE output) take an input gradient
N_CONVS, N_DGRAD, N_STRIDED = 21, 16, 4
# launches per train step
PER_STEP = dict(gather_gemm_conv=N_CONVS + N_DGRAD, gather_gemm_dw=N_CONVS,
                gather_rows=N_STRIDED, render_heatmap=1)
DEVICE = 'cuda'


def configs():
    """(stage-3 config, train config): bench.py's operating point."""
    from gga_tpu_torch.models.dense_heads.centerpoint_head_gga import \
        GGAHeadConfig
    from gga_tpu_torch.models.detectors.centerpoint_gga import GGAModelConfig
    return (GGAModelConfig(compute_dtype='bfloat16'),
            GGAModelConfig(compute_dtype='bfloat16',
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


def within_bf16_tolerance(torch, out, ref):
    """(ok, max |out - ref|) for |out - ref| <= 1e-2 max|ref| + ulp(ref)."""
    out, ref = out.float(), ref.float()
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)
    err = (out - ref).abs()
    ok = bool((err <= 1e-2 * ref.abs().max() + ulp).all())
    return ok, float(err.max())


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
    ok, err = within_bf16_tolerance(torch, out, ref)
    if not ok:
        fail(f'{label}: gather_gemm_conv (K, C, D) = {tuple(w.shape)} '
             f'disagrees with the plain version, max abs err {err}')
    R, C = f.shape
    K, Q = nmap.shape
    D = w.shape[2]
    hits = int((nmap >= 0).sum())
    read = rows_read(torch, nmap)
    nbytes = read * C * 2 + K * Q * 4 + K * C * D * 2 + Q * D * 2
    flops = 2 * hits * C * D
    b_ms, f_ms = bound_ms(nbytes, flops, BF16_FLOPS)
    return dict(K=K, C=C, D=D, R=R, Q=Q, hits=hits, rows_read=read,
                bytes=nbytes, flops=flops, max_abs_err=err,
                ms=event_ms(torch, lambda: real(f, nmap, w), 20),
                plain_ms=event_ms(torch, lambda: plain(f, nmap, w), 5),
                bytes_ms=b_ms, flops_ms=f_ms)


def print_conv_rows(title, rows):
    print(title)
    print(f'{"K":>3} {"C":>4} {"D":>4} {"calls":>5} {"Q":>7} {"hits":>9} '
          f'{"MB":>8} {"GFLOP":>7} {"ms":>8} {"plain_ms":>9} {"bound_ms":>9} '
          f'{"max_err":>8}')
    shapes = {}
    for r in rows:
        shapes.setdefault((r['K'], r['C'], r['D']), []).append(r)
    for (K, C, D), rs in shapes.items():
        s = {k: sum(r[k] for r in rs) for k in
             ('hits', 'bytes', 'flops', 'ms', 'plain_ms')}
        bound = sum(max(r['bytes_ms'], r['flops_ms']) for r in rs)
        print(f'{K:>3} {C:>4} {D:>4} {len(rs):>5} {rs[0]["Q"]:>7} '
              f'{s["hits"]:>9} {s["bytes"] / 1e6:>8.2f} '
              f'{s["flops"] / 1e9:>7.2f} {s["ms"]:>8.4f} '
              f'{s["plain_ms"]:>9.4f} {bound:>9.5f} '
              f'{max(r["max_abs_err"] for r in rs):>8.4f}')


def kernel_phase(torch, sparse_conv, bundle, pts, val, n_convs):
    with recording(sparse_conv, 'gather_gemm_conv') as calls:
        with torch.no_grad():
            bundle.model(pts, val)
    torch.cuda.synchronize()
    if len(calls) != n_convs:
        fail(f'kernel phase: expected {n_convs} sparse conv calls, saw '
             f'{len(calls)}')
    with torch.no_grad():
        rows = [conv_row(torch, sparse_conv, *args, f'kernel phase call {i}')
                for i, (_, args) in enumerate(calls)]
    print_conv_rows(f'kernel phase: gather_gemm_conv vs plain at the path\'s '
                    f'{n_convs} calls (bytes = feature rows hit + nmap + '
                    'weights + out, each once; flops = 2 * hits * C * D)',
                    rows)
    return rows


def slice_phase(torch, sparse_conv, apis, bundle, batches, n_convs):
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
        fail(f'slice phase: {launches} kernel launches for {n_fwd} forwards,'
             f' expected {n_convs * n_fwd}')
    ms = start.elapsed_time(end)
    n_valid = 0
    for out in outs:
        n = 3 * bundle.cfg.max_per_task
        if out['boxes'].shape != (B, n, 7) or out['scores'].shape != (B, n):
            fail(f'slice phase: output shapes {out["boxes"].shape}')
        for key in ('boxes', 'scores'):
            if not torch.isfinite(out[key]).all():
                fail(f'slice phase: non-finite {key}')
        n_valid += int(out['valid'].sum())
    if n_valid == 0:
        fail('slice phase: no valid detection')
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
    """BEV map and head logits with the kernels vs with the plain versions."""
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
        ok, err = within_bf16_tolerance(torch, a, b)
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


def train_phase(torch, apis, mods, trainer, batches):
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
            fail(f'train phase: {got[name]} {name} launches in {n} steps, '
                 f'expected {per * n}')
    if got['gather_rows_t'] != 0:
        fail('train phase: gather_rows_t ran on the main path')
    for logs, ev in zip(all_logs, events):
        for i, name in enumerate(names):
            stage_ms[name] += ev[i].elapsed_time(ev[i + 1]) / n
        finite_logs(torch, logs, 'train phase')
    moved = sum(int(not torch.equal(p, params0[k]))
                for k, p in trainer.model.named_parameters())
    if moved != len(params0):
        fail(f'train phase: only {moved} of {len(params0)} parameter '
             'tensors changed')
    bn_moved = sum(int(not torch.equal(b, stats0[k])
                       and bool(torch.isfinite(b).all()))
                   for k, b in trainer.model.named_buffers())
    if bn_moved != len(stats0):
        fail(f'train phase: only {bn_moved} of {len(stats0)} batch-norm '
             'statistics moved and stayed finite')
    last = {k: float(v) for k, v in all_logs[-1].items()}
    return dict(launches=got, steps=n, ms=ms,
                scenes_per_s=B * n / (ms / 1e3), breakdown=stage_ms,
                losses=[float(lg['loss']) for lg in all_logs],
                grad_norms=[float(lg['grad_norm']) for lg in all_logs],
                last_logs=last, params_moved=moved, bn_stats_moved=bn_moved)


def dw_rows(torch, sparse_conv, calls):
    rows = []
    real, plain = sparse_conv.gather_gemm_dw, sparse_conv.gather_gemm_dw_plain
    for i, (_, (f, nmap, dout)) in enumerate(calls):
        out = real(f, nmap, dout)
        ref = plain(f, nmap, dout)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        if not err <= DW_RTOL * scale:
            fail(f'train kernels: gather_gemm_dw call {i} {tuple(out.shape)} '
                 f'max abs err {err} > {DW_RTOL} * {scale}')
        R, C = f.shape
        K, Q = nmap.shape
        D = dout.shape[1]
        hits = int((nmap >= 0).sum())
        read = rows_read(torch, nmap)
        nbytes = read * C * 2 + K * Q * 4 + Q * D * 2 + K * C * D * 4
        flops = 2 * hits * C * D
        b_ms, f_ms = bound_ms(nbytes, flops, BF16_FLOPS)
        rows.append(dict(K=K, C=C, D=D, R=R, Q=Q, hits=hits, rows_read=read,
                         bytes=nbytes, flops=flops, max_abs_err=err,
                         max_abs_plain=scale,
                         ms=event_ms(torch, lambda: real(f, nmap, dout), 20),
                         plain_ms=event_ms(torch, lambda: plain(f, nmap, dout),
                                           5),
                         bytes_ms=b_ms, flops_ms=f_ms))
    print_conv_rows('train kernels: gather_gemm_dw vs plain at the step\'s '
                    f'{len(rows)} calls (bytes = feature rows hit + nmap + '
                    'dout + f32 out; flops = 2 * hits * C * D)', rows)
    return rows


def rows_rows(torch, gr, calls, transposed):
    """gather_rows (or gather_rows_t on (features, map) pairs) vs plain,
    exact; gather_rows also against index_select on a zero-padded source."""
    real = gr.gather_rows_t if transposed else gr.gather_rows
    plain = gr.gather_rows_t_plain if transposed else gr.gather_rows_plain
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
                   plain_ms=event_ms(torch, lambda: plain(src, idx), 20),
                   bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops_ms=0.0,
                   library_ms=None)
        if not transposed:
            src0 = torch.cat([src.new_zeros(1, src.shape[1]), src])
            idx1 = (idx + 1).long()
            if not torch.equal(torch.index_select(src0, 0, idx1), out):
                fail('train kernels: index_select yardstick disagrees')
            row['library_ms'] = event_ms(
                torch, lambda: torch.index_select(src0, 0, idx1), 20)
        rows.append(row)
    name = 'gather_rows_t' if transposed else 'gather_rows'
    print(f'train kernels: {name} vs plain (exact) at {len(rows)} calls '
          '(bytes = source rows hit + indices + output, each once)')
    for r in rows:
        lib = ('' if r['library_ms'] is None
               else f' index_select {r["library_ms"]:.4f} ms')
        print(f'  src [{r["N"]}, {r["C"]}] idx {r["idx"]} misses '
              f'{r["misses"]}, rows read {r["rows_read"]}: {r["ms"]:.4f} ms, '
              f'plain {r["plain_ms"]:.4f} ms, bound {r["bytes_ms"]:.5f} ms'
              f'{lib}')
    return rows


def heatmap_rows(torch, heatmap, calls):
    rows = []
    real, plain = heatmap.render_heatmap, heatmap.render_heatmap_plain
    for centers, radii, valid, hw in (args for _, args in calls):
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
                         ms=event_ms(torch, lambda: real(centers, radii,
                                                         valid, hw), 20),
                         plain_ms=event_ms(torch, lambda: plain(
                             centers, radii, valid, hw), 5),
                         bytes_ms=b_ms, flops_ms=f_ms))
    for r in rows:
        print(f'train kernels: render_heatmap vs plain: {r["G"]} maps of '
              f'{r["H"]}x{r["W"]}, {r["live"]} live of {r["G"] * r["M"]} '
              f'objects, {r["ones"]} centre pixels; max err '
              f'{r["max_abs_err"]:.3g}; {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, bound '
              f'{max(r["bytes_ms"], r["flops_ms"]):.5f}'
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
    versions, same weights, batch and SRL draw. The rounding noise of the
    bf16 step is read without the kernels: the plain step against the
    plain step with a one-ulp perturbation of the encoder input."""
    srl = torch.randn((3, B), generator=torch.Generator().manual_seed(5)).to(
        batch['labels'].device)
    loss_k, norm_k, g_k, bn_k = loss_and_grads(torch, trainer, batch, srl)
    with plain_versions(wrappers(mods)):
        loss_p, norm_p, g_p, bn_p = loss_and_grads(torch, trainer, batch,
                                                   srl)
        with input_ulp_noise(torch, trainer.model):
            _, _, g_n, _ = loss_and_grads(torch, trainer, batch, srl)

    def cosines(a, b):
        return {n: float(torch.nn.functional.cosine_similarity(
            a[n].flatten(), b[n].flatten(), dim=0)) for n in a}

    cos, cos_noise = cosines(g_k, g_p), cosines(g_p, g_n)
    # the bf16 step's batch-norm statistics: each buffer's update agrees
    # within 1e-2 of its largest entry (means and variances in f32 of
    # bf16 activations that differ by rounding)
    bn_err = {n: float((bn_k[n] - bn_p[n]).abs().max()
                       / bn_p[n].abs().max().clamp(min=1e-12)) for n in bn_p}
    if not all(torch.isfinite(v).all() for v in bn_k.values()):
        fail('step comparison: non-finite batch-norm statistics')
    worst_bn = max(bn_err, key=bn_err.get)
    if not bn_err[worst_bn] <= 1e-2:
        fail(f'step comparison: batch-norm update of {worst_bn} differs by '
             f'{bn_err[worst_bn]} of its largest entry')
    res = dict(loss_kernel=loss_k, loss_plain=loss_p,
               loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               grad_norm_kernel=norm_k, grad_norm_plain=norm_p,
               grad_norm_rel=abs(norm_k - norm_p) / norm_p,
               conv_weight_grads=len(cos), min_cosine=min(cos.values()),
               min_cosine_plain_ulp_noise=min(cos_noise.values()),
               bn_update_max_rel_err=bn_err[worst_bn], bn_buffers=len(bn_err),
               cosines=cos, cosines_plain_ulp_noise=cos_noise)
    if len(cos) != N_CONVS:
        fail(f'step comparison: {len(cos)} sparse conv weight gradients, '
             f'expected {N_CONVS}')
    if not res['loss_rel'] <= 1e-2:
        fail(f'step comparison: loss {loss_k} vs plain {loss_p}')
    if not res['grad_norm_rel'] <= 5e-2:
        fail(f'step comparison: grad norm {norm_k} vs plain {norm_p}')
    # cosine >= 0.99, or, where one ulp at the input already moves the
    # plain step's gradient further, no more than twice that far from it
    # and never below the fixed floor
    for n, c in cos.items():
        if not (c >= COSINE_MIN or (c >= COSINE_FLOOR
                                    and 1 - c <= 2 * (1 - cos_noise[n]))):
            fail(f'step comparison: {n} weight gradient cosine {c} < '
                 f'{COSINE_MIN} and beyond twice the plain step\'s one-ulp '
                 f'noise (cosine {cos_noise[n]}) or {COSINE_FLOOR}')
    return res


def kernel_entry(name, source, replaces, launches, rows, library_ms=None):
    bytes_ms = sum(r['bytes_ms'] for r in rows)
    flops_ms = sum(r['flops_ms'] for r in rows)
    return dict(
        name=name, route='cuda', source=f'gga_tpu_torch/kernels/csrc/{source}',
        replaces=replaces, launches=launches,
        max_abs_err=max(r['max_abs_err'] for r in rows),
        ms=sum(r['ms'] for r in rows),
        plain_ms=sum(r['plain_ms'] for r in rows),
        bound_ms=sum(max(r['bytes_ms'], r['flops_ms']) for r in rows),
        bound_by='bytes' if bytes_ms >= flops_ms else 'operations',
        library_ms=library_ms)


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

    def points(seed):
        b = make_batch(B, P, M_OBJ, PC, seed)
        return (torch.from_numpy(b['points']).to(dev),
                torch.from_numpy(b['points_valid']).to(dev))

    rows = kernel_phase(torch, sparse_conv, bundle, *points(0),
                        n_convs=N_CONVS)
    batches = [points(s) for s in range(1, 5)]
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

    def train_batch(seed):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in make_batch(B, P, M_OBJ, PC, seed).items()}

    tbatches = [train_batch(s) for s in range(10, 11 + TRAIN_STEPS)]
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
    conv_calls = rec['gather_gemm_conv']
    fwd_calls = [a for ph, a in conv_calls if ph == 'forward']
    dgrad_calls = [a for ph, a in conv_calls if ph == 'backward']
    if (len(fwd_calls), len(dgrad_calls)) != (N_CONVS, N_DGRAD):
        fail(f'warm-up step: {len(fwd_calls)} forward and {len(dgrad_calls)}'
             f' input-gradient convs, expected {N_CONVS} and {N_DGRAD}')
    conv_rows = [conv_row(torch, sparse_conv, *a, f'train call {i}')
                 for i, a in enumerate(fwd_calls + dgrad_calls)]
    print_conv_rows('train kernels: gather_gemm_conv vs plain at the step\'s '
                    f'{N_CONVS} forward calls', conv_rows[:N_CONVS])
    print_conv_rows('train kernels: gather_gemm_conv vs plain at the step\'s '
                    f'{N_DGRAD} submanifold input-gradient calls',
                    conv_rows[N_CONVS:])
    dwr = dw_rows(torch, sparse_conv, rec['gather_gemm_dw'])
    gr_rows = rows_rows(torch, gr, [a for _, a in rec['gather_rows']], False)
    strided = [(f, nmap) for f, nmap, _ in fwd_calls
               if any(nmap is m for m in strided_maps)]
    if len(strided) != N_STRIDED:
        fail(f'train kernels: found {len(strided)} strided forward maps, '
             f'expected {N_STRIDED}')
    grt_rows = rows_rows(torch, gr, strided, True)
    hm_rows = heatmap_rows(torch, heatmap, rec['render_heatmap'])
    del rec, conv_calls, fwd_calls, dgrad_calls, strided
    torch.set_grad_enabled(True)

    cmp_step = step_comparison(torch, mods, trainer, tbatches[1])
    print(f'whole step kernels vs plain: loss {cmp_step["loss_kernel"]:.6g} '
          f'vs {cmp_step["loss_plain"]:.6g} (rel {cmp_step["loss_rel"]:.3g}),'
          f' grad norm {cmp_step["grad_norm_kernel"]:.6g} vs '
          f'{cmp_step["grad_norm_plain"]:.6g} (rel '
          f'{cmp_step["grad_norm_rel"]:.3g}), min cosine of the '
          f'{N_CONVS} sparse conv weight gradients '
          f'{cmp_step["min_cosine"]:.6f} (plain step, one ulp of input '
          f'noise: {cmp_step["min_cosine_plain_ulp_noise"]:.6f}); batch-norm '
          f'updates of {cmp_step["bn_buffers"]} buffers within '
          f'{cmp_step["bn_update_max_rel_err"]:.3g} of their largest entry')

    launches = tr['launches']
    kernels = [
        kernel_entry('gather_gemm_conv', 'gather_gemm.cu',
                     'gga_tpu/ops/pallas/window_gather.py:266',
                     launches['gather_gemm_conv'], conv_rows),
        kernel_entry('gather_gemm_dw', 'gather_gemm_dw.cu',
                     'gga_tpu/ops/pallas/window_gather.py:312',
                     launches['gather_gemm_dw'], dwr),
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
                       train_heatmap=hm_rows, step_comparison=cmp_step),
                  fh, indent=1, default=str)

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
