#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-3 inference and GGA weak training
paths, the GGA workflow's command-line tools, the stage-4 PGD retrain,
the indoor FCAF3D retrain, the fully supervised SECOND and PointPillars,
the accuracy benches, the rest of the KITTI voxel detectors (DVSECOND,
SASSD, DynamicVoxelNet), the fully supervised nuScenes CenterPoint and
the two-stage PartA2 on one NVIDIA card.

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
   SRL draw, cuDNN off on both sides (its algorithm choice follows the
   free workspace, so the two sides could run different dense plans): loss within 1e-2 relative, grad norm within 5e-2 relative,
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
12. Supervised phase (``supervised_phase``), the fully supervised KITTI
    path on the workflow's mini KITTI (its 16 trainval scenes and 8 val
    scenes, the reduced clouds): SECOND as shipped
    (configs/second/hv_second_secfpn_6x8_80e_kitti-3d-3class.py, f32,
    B = 6 x 24 000 points, 16 000 voxels of a 41 x 1600 x 1408 grid).
    One recorded train step's 19 gather_gemm_conv (12 forward, 7 SubM
    input gradients), 12 gather_gemm_dw and 4 gather_rows calls are
    replayed against their plain versions within the f32 gates and timed
    per (K, C, D); the eval-mode BEV and head maps with the kernels
    against the plain versions (1e-4 of max|plain|); one whole step with
    kernels against plain (the f32 gates of 8.); then
    ``train_supervised`` for 4 steps (2 an epoch) with exact launches
    (19 / 12 / 4 a step, nothing else), CUDA events around each step and
    at its stage marks (forward, assign + loss, backward, clip + AdamW),
    finite losses with positives, each step's lr, every parameter and BN
    statistic moved, the head maps and decode from the newest checkpoint
    equal to the in-memory weights' bit for bit, and a profile of one
    more step; ``infer_anchor`` on the 8 val scenes (12 launches a
    forward) and ``kitti_eval``; PointPillars as shipped through the same
    CLI for 2 steps with no kernel launch. Prints scenes/s (events and
    with the loader), device ms by stage, peak memory, checkpoint MiB
    and ms, budget occupancy and inference scenes/s, each beside the
    card's name and power limit.
13. Accuracy phase (``accuracy_phase``), the accuracy benches of
    gga_tpu_torch/tools/: 16 synthetic scenes from seed 0 with their
    stage-1 weak labels, whose AP must equal the value the CPU test pins
    against gga_tpu (ACC_STAGE1_AP); the weak-train step of the round-5
    recipe (GGAModelConfig.small(), f32, B = 8: --flat-lr --pal
    --dim-prior 3.0 --yaw-prior 1.0 --containment 1.0) recorded on the
    CLI's first batch, its 21 gather_gemm_conv, 13 gather_gemm_dw, 4
    gather_rows (cold L2) and 1 render_heatmap calls replayed against
    their plain versions within the f32 gates and timed; then
    ``accuracy_bench`` for ACC_STEPS steps with an eval every
    ACC_EVAL_EVERY (exact launches 21 / 13 / 4 / 1 at every step and 13
    at every eval forward, finite losses, the four AP keys untrained and
    trained, the saved state reloaded evaluating twice to the CLI's
    trained AP) and ``accuracy_bench_stage4`` on its pseudo-label dump
    (no kernel launch, finite losses with positives at every step, the
    five AP keys, repeated final evals equal). Prints, beside the card's
    name and power limit, weak-train scenes/s by CUDA events around each
    step and with the loader, eval scenes/s, stage-4 images/s, the AP
    values and the phase's seconds. No AP value is a gate.
14. Voxel family phase (``voxel_family_phase``), the rest of the KITTI
    voxel detectors through the same CLI and ``anchor_path`` as SECOND's
    (12.), each config as shipped on the same mini KITTI (B = 6, up to
    24 000 points a scene), f32: DVSECOND (the dv_second 2x8 cosine
    config, which the CLI trains on the cyclic schedule, as gga_tpu's)
    and SASSD, its two auxiliary losses finite and logged. Each: the
    recorded step's 19 / 12 / 4 kernel calls replayed against plain, the
    eval forward and a whole step against plain, ``train_supervised`` for
    3 steps across an epoch boundary with exact launches 19 / 12 / 4 a
    step, each step's lr, moved weights, the newest checkpoint's maps and
    decode bit for bit, a profile of one more step, ``infer_anchor`` +
    ``kitti_eval`` on the val scenes (SASSD without its branch). Then
    SASSD's peak memory over one
    step with and without the branch (SECOND on the same config), and
    DynamicVoxelNet (dv_pointpillars car) through the CLI for 2 steps and
    ``infer_anchor`` with no kernel launch; the passes
    ``dynamic_scatter_mean`` takes a forward (its largest voxel's point
    count) printed for it and DVSECOND.
15. CenterPoint phase (``centerpoint_phase``, last), supervised
    CenterPoint on a mini nuScenes written from seed 0
    (``write_mini_nuscenes``: 8 train and 4 val key frames, each with 10
    past sweeps 0.05 s apart from a moving ego, every sweep 34 720
    ray-cast returns of a 32-beam lidar, 20-40 boxes of the ten classes
    with velocities), read through ``NuScenesDataset`` as configured
    (60 000 points of 11 sweeps, 128 object slots), f32, B = 4, seeded
    random weights. The 0.1 m voxel config as shipped
    (configs/centerpoint/centerpoint_01voxel_second_secfpn_4x8_cyclic_
    20e_nus.py, 90 000 voxels of a 41 x 1024 x 1024 grid): 4 calls of
    ``apis.centerpoint_train_step``, each recorded, with exact launches
    at every step (17 gather_gemm_conv, 11 gather_gemm_dw, 4
    gather_rows, 1 render_heatmap of all 40 class maps), each step's lr,
    finite losses, moved weights, active sites against every budget,
    device ms by stage and peak memory; every call of every step against
    its plain version at the f32 gates, step 1's calls timed beside their
    bounds; one whole step with kernels against plain (the f32 gates of
    8.) on the seeded initial weights, before the recorded steps; a
    profile of one more step; then ``infer_centerpoint`` (11
    launches a forward), ``format_results`` and ``nuscenes_eval`` on the
    val key frames (mAP and NDS finite; no AP is a gate). The 0.075 m
    DCN circle-NMS config and the 0.2 m pillar DCN config (no sparse
    conv, one heatmap launch a step) for 2 steps and an inference each,
    with the same launch, replay and finiteness gates. Each path's
    batch norms take one train batch's statistics before its inference
    (``calibrate_bn``).
16. PartA2 phase (``parta2_phase``, after the CenterPoint phase) on the
    workflow's mini KITTI: the 3-class config as shipped
    (configs/parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-3class.py:
    SparseUNet with the inverse sparse conv on 16 000 voxels of a
    41 x 1600 x 1408 grid, SECOND + SECONDFPN, the RPN, the semantic head,
    RoI-aware pooling and the part-aggregation bbox head; f32, B = 2,
    seeded random weights). One whole step with kernels against plain
    (the f32 gates of 8., cuDNN off, the kernel step's proposals given to
    every step) on the initial weights and the first batch, the same on
    two more batches printed, not gated, and one forward + backward timed
    with cuDNN on and off; 3 calls of
    ``apis.parta2_train_step`` across an epoch boundary, each recorded,
    with exact launches at every step (55 gather_gemm_conv: 28 forward,
    27 input gradients; 28 gather_gemm_dw; nothing else), each step's lr,
    finite losses, moved weights, active sites against every budget,
    device ms by stage and peak memory; every call of every step against
    its plain version, step 1's timed beside their bounds; a profile of
    one more step; ``calibrate_bn``, then ``infer_parta2`` on the 8 val
    scenes (28 launches a forward, finite boxes). The proposals kept and
    the positive RoIs a step are printed, not gated.
17. Prints one JSON line describing the kernels (each with its time
    ms, device_ms, launches, bound and bound_share = bound_ms / ms,
    device_bound_share = bound_ms / device_ms, host_ms where measured;
    the f32 entries as gather_gemm_conv_f32 and gather_gemm_dw_f32, with
    ffma_bound_ms, their bound at the FFMA rate of 67 TFLOP/s, an
    ``indoor`` dict with the same numbers over FCAF3D's recorded step,
    ``second``, ``dvsecond`` and ``sassd`` dicts over those detectors'
    steps, which gather_rows carries too, and ``accuracy`` and
    ``centerpoint`` dicts over the accuracy bench's and the 0.1 m
    CenterPoint config's steps on the two f32 sparse-conv entries,
    gather_rows and render_heatmap, and ``parta2`` dicts over PartA2's
    steps on the two f32 sparse-conv entries),
    the card, then, as the last line, {"ok": true, "device": {...}}. Any
    failed phase exits non-zero.

Everything it measures is also written to chiprun_out/chip_smoke.json.
"""
import contextlib
import functools
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
L2_FLUSH_BYTES = 4 * 50 * 2 ** 20  # four times the H100's 50 MB L2
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


def cold_event_ms(torch, fn, reps, flush):
    """Mean device time of ``fn`` over ``reps`` runs, each on a cold L2:
    ``flush``, a buffer larger than the L2, is written before every run,
    outside the events around it; after one warm-up."""
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        fn()
        pair[1].record()
        pairs.append(pair)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


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


def recorded_step(torch, apis, sp, mods, trainer, batch, step_fn=None):
    """One train step (``step_fn(trainer, batch, mark)``, by default
    ``apis.train_step``) that records the arguments of every kernel call,
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
        logs = (step_fn or apis.train_step)(trainer, batch, mark)
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


def rows_rows(torch, gr, calls, transposed, label='train kernels',
              flush=None):
    """gather_rows (or gather_rows_t on (features, map) pairs) vs plain,
    exact; gather_rows also against index_select on a zero-padded source.
    With ``flush`` (a buffer larger than the L2) every timed call runs on
    a cold L2: the buffer is written before it, outside its time."""
    name = 'gather_rows_t' if transposed else 'gather_rows'
    real, plain = getattr(gr, name), getattr(gr, name + '_plain')

    def timed(fn):
        return (event_ms(torch, fn, 20) if flush is None
                else cold_event_ms(torch, fn, 20, flush))

    def cold(fn):
        return fn if flush is None else lambda: (flush.zero_(), fn())
    rows = []
    for i, (src, idx) in enumerate(calls):
        out = real(src, idx)
        ref = plain(src, idx)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f'{label}: {real.__name__} call {i} differs from the '
                 'plain version')
        esize = src.element_size()
        read = rows_read(torch, idx)
        nbytes = (read * src.shape[1] * esize + idx.numel() * 4
                  + out.numel() * esize)
        row = dict(N=src.shape[0], C=src.shape[1], idx=tuple(idx.shape),
                   misses=int((idx < 0).sum()), rows_read=read, bytes=nbytes,
                   max_abs_err=0.0,
                   ms=timed(lambda: real(src, idx)),
                   device_ms=device_ms(torch, cold(lambda: real(src, idx)),
                                       20, KERNEL_NAMES[name]),
                   plain_ms=timed(lambda: plain(src, idx)),
                   bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, flops_ms=0.0,
                   library_ms=None, host_ms=None)
        if transposed:
            row['host_ms'] = host_ms(torch, lambda: real(src, idx))
        else:
            src0 = torch.cat([src.new_zeros(1, src.shape[1]), src])
            idx1 = (idx + 1).long()
            if not torch.equal(torch.index_select(src0, 0, idx1), out):
                fail(f'{label}: index_select yardstick disagrees')
            row['library_ms'] = timed(
                lambda: torch.index_select(src0, 0, idx1))
        rows.append(row)
    print(f'{label}: {name} vs plain (exact) at {len(rows)} calls '
          '(bytes = source rows hit + indices + output, each once; ms by '
          'CUDA events, device by the profiler'
          + ('' if flush is None else
             f'; each call on a cold L2, {flush.nbytes >> 20} MiB written '
             'before it') + ')')
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


def heatmap_rows(torch, heatmap, calls, label='train kernels'):
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
            fail(f'{label}: render_heatmap differs from plain, max abs '
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
        print(f'{label}: render_heatmap vs plain: {r["G"]} maps of '
              f'{r["H"]}x{r["W"]}, {r["live"]} live of {r["G"] * r["M"]} '
              f'objects, {r["ones"]} centre pixels; max err '
              f'{r["max_abs_err"]:.3g}; {r["ms"]:.4f} ms by CUDA events, '
              f'device {fmt_ms(r["device_ms"])} (share '
              f'{share(bound, r["device_ms"])}), host {r["host_ms"]:.4f} ms '
              f'a call, plain {r["plain_ms"]:.4f} ms, bound {bound:.5f}'
              f' ms ({r["bytes"]} bytes, {r["flops"]} ops)')
    return rows


def gga_loss(model, batch, srl):
    """The GGA weak loss of one train-mode forward (``srl``: the SRL
    prior's normal draw)."""
    from gga_tpu_torch.models.dense_heads import centerpoint_head_gga as gga
    head = model.cfg.head
    preds = model(batch['points'], batch['points_valid'], {})
    targets = gga.build_targets(head, srl, batch['labels'],
                                batch['obj_valid'], batch['init_pseudo'],
                                batch['boxes_img'], batch['bdry_masks'],
                                batch['lidar2img'])
    return gga.loss(head, preds, targets, batch['ibp_xy'],
                    batch['ibp_valid'])[0]


def loss_and_grads(torch, trainer, batch, loss_fn, conv_types=None):
    """One step's loss (``loss_fn(model, batch)`` of a train-mode
    forward), gradient norm, sparse conv weight gradients (of the modules
    of ``conv_types``, by default the submanifold and compact strided
    convs) and batch-norm statistics updates, without the optimizer; the
    running statistics are restored afterwards."""
    from gga_tpu_torch.models.layers import SubMConv3d, SparseConv3d
    conv_types = conv_types or (SubMConv3d, SparseConv3d)
    model = trainer.model
    model.train()
    model.zero_grad(set_to_none=True)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    total = loss_fn(model, batch)
    total.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    conv_grads = {n: m.weight.grad.detach().clone()
                  for n, m in model.named_modules()
                  if isinstance(m, conv_types)}
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
    enc = getattr(model, 'pts_middle_encoder', None) or model.middle_encoder
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


def conv_reordered(torch, f, nmap, w):
    """``gather_gemm_conv_plain`` with its sums in another order: tap by
    tap from the last, each tap's products summed by a GEMM of its own."""
    hit = (nmap >= 0)[..., None]
    g = torch.where(hit, f[nmap.clamp(min=0)], 0).float()     # [K, Q, C]
    out = g.new_zeros(g.shape[1], w.shape[2])
    for k in reversed(range(g.shape[0])):
        out += g[k] @ w[k].float()
    return out.to(f.dtype)


def dw_reordered(torch, f, nmap, dout, rows=4096):
    """``gather_gemm_dw_plain`` with its sums in another order: blocks of
    ``rows`` q rows, added from the last."""
    out = 0
    for q in reversed(range(0, nmap.shape[1], rows)):
        m = nmap[:, q:q + rows]
        g = torch.where((m >= 0)[..., None], f[m.clamp(min=0)], 0)
        out = out + torch.einsum('kqc,qd->kcd', g.float(),
                                 dout[q:q + rows].float())
    return out


@contextlib.contextmanager
def plain_reordered(torch, mods):
    """The plain versions, the sparse convs' with their sums in another
    order: an f32 step that is as exact as the plain one."""
    sparse_conv = mods[0]
    with plain_versions(wrappers(mods)):
        sparse_conv.gather_gemm_conv = functools.partial(conv_reordered, torch)
        sparse_conv.gather_gemm_dw = functools.partial(dw_reordered, torch)
        yield


def step_comparison(torch, mods, trainer, batch, loss_fn=None,
                    n_convs=None, conv_types=None, gated=True):
    """Loss and gradients of one step with the kernels vs the plain
    versions, same weights and batch (and SRL draw: ``loss_fn`` defaults
    to the GGA loss with a seeded one), within the gates of the model's
    dtype. The step's rounding noise is read without the kernels: the
    plain step against the plain step with a one-ulp perturbation (of the
    model's dtype) of the encoder input. The plain step with the sparse
    convs' sums in another order (``plain_reordered``) is reported beside
    it, and gates nothing. ``gated=False`` measures the same and gates
    nothing.

    All three steps run with cuDNN off, so the dense layers compute the
    same arithmetic on both sides: with it on, cuDNN picks each conv's
    algorithm (an FFT plan or an implicit GEMM) by the workspace the
    allocator can give at that moment, which the plain versions' larger
    temporaries change, and two plans' rounding can move SECOND's
    conv_input weight gradient (a small remainder of large sums) past
    the gate where the kernels do not."""
    # CenterPoint's config has no dtype: it runs in f32
    gate = GATES[getattr(trainer.model.cfg, 'compute_dtype', 'float32')]
    n_convs = N_CONVS if n_convs is None else n_convs
    if loss_fn is None:
        srl = torch.randn((3, B), generator=torch.Generator().manual_seed(
            5)).to(batch['labels'].device)

        def loss_fn(model, b):
            return gga_loss(model, b, srl)
    with torch.backends.cudnn.flags(enabled=False):
        loss_k, norm_k, g_k, bn_k = loss_and_grads(torch, trainer, batch,
                                                   loss_fn, conv_types)
        with plain_versions(wrappers(mods)):
            loss_p, norm_p, g_p, bn_p = loss_and_grads(torch, trainer, batch,
                                                       loss_fn, conv_types)
            with input_ulp_noise(torch, trainer.model):
                _, norm_n, g_n, _ = loss_and_grads(torch, trainer, batch,
                                                   loss_fn, conv_types)
        with plain_reordered(torch, mods):
            _, norm_r, g_r, _ = loss_and_grads(torch, trainer, batch, loss_fn,
                                               conv_types)

    def cosines(a, b):
        return {n: float(torch.nn.functional.cosine_similarity(
            a[n].flatten(), b[n].flatten(), dim=0)) for n in a}

    cos, cos_noise = cosines(g_k, g_p), cosines(g_p, g_n)
    cos_reordered = cosines(g_p, g_r)
    # each batch-norm buffer's update agrees within the gate of its
    # largest entry (means and variances in f32 of activations that
    # differ by rounding)
    bn_err = {n: float((bn_k[n] - bn_p[n]).abs().max()
                       / bn_p[n].abs().max().clamp(min=1e-12)) for n in bn_p}
    worst_bn = max(bn_err, key=bn_err.get)
    res = dict(loss_kernel=loss_k, loss_plain=loss_p,
               loss_rel=abs(loss_k - loss_p) / abs(loss_p),
               grad_norm_kernel=norm_k, grad_norm_plain=norm_p,
               grad_norm_rel=abs(norm_k - norm_p) / norm_p,
               grad_norm_rel_plain_ulp_noise=abs(norm_n - norm_p) / norm_p,
               conv_weight_grads=len(cos), min_cosine=min(cos.values()),
               min_cosine_plain_ulp_noise=min(cos_noise.values()),
               grad_norm_rel_plain_reordered=abs(norm_r - norm_p) / norm_p,
               min_cosine_plain_reordered=min(cos_reordered.values()),
               bn_update_max_rel_err=bn_err[worst_bn], bn_buffers=len(bn_err),
               cosines=cos, cosines_plain_ulp_noise=cos_noise,
               cosines_plain_reordered=cos_reordered)
    if not gated:
        return res
    if not all(torch.isfinite(v).all() for v in bn_k.values()):
        fail('step comparison: non-finite batch-norm statistics')
    if not bn_err[worst_bn] <= gate['bn']:
        fail(f'step comparison: batch-norm update of {worst_bn} differs by '
             f'{bn_err[worst_bn]} of its largest entry')
    if len(cos) != n_convs:
        fail(f'step comparison: {len(cos)} sparse conv weight gradients, '
             f'expected {n_convs}')
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
# class: (dims l, w, h in m, share of the objects)
WF_CLASSES = dict(Car=((3.9, 1.6, 1.56), 0.5),
                  Pedestrian=((0.8, 0.6, 1.73), 0.25),
                  Cyclist=((1.76, 0.6, 1.73), 0.25))


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
    from each scene's points (``synth.render_scene_image``, written with
    all five PNG row filters by ``png.write_png``). Returns the points
    each scene has in the camera's view."""
    import os

    from gga_tpu_torch.core import np_geometry as ng
    from gga_tpu_torch.data.kitti.png import write_png
    from gga_tpu_torch.data.kitti.synth import (IMG_SHAPE, P2, VELO2CAM,
                                                render_scene_image)
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
            write_png(os.path.join(sub, 'image_2', f'{idx:06d}.png'),
                      render_scene_image(pts))
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


# --- the fully supervised KITTI path: SECOND and PointPillars -------------

SUP_SECOND = 'configs/second/hv_second_secfpn_6x8_80e_kitti-3d-3class.py'
SUP_PILLARS = ('configs/pointpillars/'
               'hv_pointpillars_secfpn_6x8_160e_kitti-3d-3class.py')
SUP_INFO = 'kitti_infos_trainval_GGA.pkl'   # the workflow's 16 scenes
SUP_VAL_INFO = 'kitti_infos_val_GGA.pkl'    # its 8 val scenes
SUP_STEPS = 4               # SECOND's --max-steps: 2 an epoch at B = 6
SUP_PP_STEPS = 2            # PointPillars' --max-steps
SUP_OPTIONS = ('log_interval=1',)
SUP_EVAL_BATCH = 4          # scenes a forward of infer_anchor
# SECOND's conv_module encoder: conv_input + stage 0's SubM + 2 SubM in
# each of stages 1-3 (8 SubM), the 3 strided convs opening stages 1-3 and
# conv_out (4 strided); every SubM but conv_input (whose input, the VFE's
# mean, needs none) takes an input gradient through gather_gemm_conv, the
# strided convs through gather_rows
SUP_CONVS, SUP_DGRAD, SUP_STRIDED = 12, 7, 4
SUP_PER_STEP = dict(gather_gemm_conv=SUP_CONVS + SUP_DGRAD,
                    gather_gemm_dw=SUP_CONVS, gather_rows=SUP_STRIDED,
                    gather_rows_t=0, render_heatmap=0)
SUP_STAGES = ('forward', 'assign+loss', 'backward', 'clip+optimizer')


def anchor_loss(model, batch):
    """The anchor loss of one train-mode forward (the train step's body
    without the optimizer; SASSD's auxiliary losses included)."""
    from gga_tpu_torch.train import loop
    return loop.anchor_loss(model, batch)[0]


def anchor_plain_comparison(torch, mods, model, pts, val):
    """The eval-mode BEV map and head maps with the kernels vs the plain
    versions, within the f32 forward gate of max|plain|."""
    gate = GATES['float32']['forward']

    def run():
        with torch.no_grad():
            bev = model.eval().extract_bev(pts, val)
            return dict(bev=bev, **model.head(bev))

    out_k = run()
    with plain_versions(wrappers(mods)):
        out_p = run()
    torch.cuda.synchronize()
    res = {}
    for key, a in out_k.items():
        ok, err = within_tolerance(torch, a, out_p[key], gate)
        res[key] = dict(max_abs_err=err,
                        max_abs_plain=float(out_p[key].abs().max()))
        if not ok:
            fail(f'supervised plain comparison: {key} differs, max abs err '
                 f'{err}')
    return res


def supervised_run(torch, mods, card, argv, per_step, batch, label,
                   positives=True):
    """``train_supervised.main(argv)`` with CUDA events around each step
    and at each stage mark, the counts set to 0 just before and read just
    after, exact launches a step, finite losses, and (``positives``)
    positive anchors at every step. Returns (summary, trainer)."""
    import json as json_

    from gga_tpu_torch import apis
    from gga_tpu_torch.tools import train_supervised
    trainers, events, diags = [], [], []
    real_step = apis.anchor_train_step

    def timed_step(trainer, b):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        marks = iter(ev[1:])
        diag = {}
        ev[0].record()
        logs = real_step(trainer, b, lambda _: next(marks).record(), diag)
        trainers.append(trainer)
        events.append(ev)
        diags.append(diag)
        return logs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    apis.anchor_train_step = timed_step
    try:
        zero_counts(mods)
        summ = train_supervised.main(argv)
        got = counts(mods)
    finally:
        apis.anchor_train_step = real_step
    n = summ['steps']
    want = {k: v * n for k, v in per_step.items()}
    if got != want:
        fail(f'{label}: train_supervised launched {got} in {n} steps, '
             f'expected {want}')
    torch.cuda.synchronize()
    step_ms = [ev[0].elapsed_time(ev[4]) for ev in events]
    stage_ms = {name: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                                     for ev in events[1:]]))
                for i, name in enumerate(SUP_STAGES)}
    with open(summ['log']) as f:
        lines = [json_.loads(ln) for ln in f]
    if [ln['step'] for ln in lines] != list(range(1, n + 1)):
        fail(f'{label}: logged steps {[ln["step"] for ln in lines]}')
    for ln in lines:
        bad = [k for k, v in ln.items() if 'loss' in k
               and not np.isfinite(v)]
        if bad or (positives and not ln['num_pos'] > 0):
            fail(f'{label}: step {ln["step"]}: non-finite {bad}, num_pos '
                 f'{ln["num_pos"]}')
    summ.update(launches=got, step_device_ms=step_ms, stage_ms=stage_ms,
                peak_bytes=torch.cuda.max_memory_allocated(), lines=lines,
                occupancy_out=[float(d['occupancy_out']) for d in diags
                               if 'occupancy_out' in d],
                scenes_per_s_events=batch * (len(step_ms) - 1)
                / (sum(step_ms[1:]) / 1e3))
    print(f'{card}: {label}: train_supervised {n} steps at B={batch} '
          f'(f32): after the first step {summ["scenes_per_s"]:.3f} scenes/s '
          f'with the loader, {summ["scenes_per_s_events"]:.3f} by CUDA '
          f'events around the steps; step device ms '
          f'{[round(v, 1) for v in step_ms]}; by stage (mean after the '
          'first) ' + ', '.join(f'{k} {v:.2f}' for k, v in stage_ms.items())
          + f'; peak memory {summ["peak_bytes"] / 2 ** 30:.2f} GiB; losses '
          f'{[round(ln["loss"], 3) for ln in lines]}, num_pos '
          f'{[ln["num_pos"] for ln in lines]}; launches {got}')
    return summ, trainers[-1]


def moved_from_init(torch, apis, model_cfg, trainer, label, seed,
                    unreached=()):
    """Fail unless every parameter and BN statistic moved from the weights
    seeded with ``seed`` (the config's, as the CLI seeds its trainer), but
    the ``unreached`` ones: parameters that no gradient reaches and that
    weight decay leaves (zero biases)."""
    init = apis.init_anchor_detector(model_cfg, device=DEVICE,
                                     seed=seed).model
    init = init.state_dict()
    now = trainer.model.state_dict()
    names = dict(trainer.model.named_parameters())
    stuck = [k for k in names if torch.equal(now[k], init[k])
             and k not in unreached]
    bn = [k for k in now if k.endswith(('running_mean', 'running_var'))]
    bn_stuck = [k for k in bn if torch.equal(now[k], init[k])]
    if stuck or bn_stuck:
        fail(f'{label}: {len(stuck)} parameter tensors and {len(bn_stuck)} '
             f'BN statistics did not move: {(stuck + bn_stuck)[:8]}')
    return len(names), len(bn)


def supervised_options(data):
    """The CLI's --cfg-options on the workflow's mini KITTI."""
    return ['--cfg-options', f'data_root={data}/',
            f'data.train_info={SUP_INFO}', *SUP_OPTIONS]


def supervised_data(torch, data, config):
    """(file-level config with the mini KITTI's options, model config,
    batch size, train dataset, first batch on the card)."""
    import os

    from gga_tpu_torch import tools_lib
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    opts = supervised_options(data)
    cfg = Config.fromfile(config).merge_from_options(
        dict(kv.split('=', 1) for kv in opts[1:]))
    d = cfg.data
    dataset = KittiDetDataset(data, os.path.join(data, SUP_INFO),
                              pc_range=cfg.point_cloud_range,
                              pts_prefix=d.pts_prefix,
                              max_points=d.max_points, seed=cfg.seed)
    b0 = {k: torch.as_tensor(v, device=DEVICE) for k, v in
          next(dataset.epoch_batches(d.samples_per_gpu, seed=0)).items()}
    return (cfg, tools_lib.model_config_from_cfg(cfg), d.samples_per_gpu,
            dataset, b0)


def anchor_path(torch, mods, card, tmp, config, label, steps, profile=False,
                log_keys=()):
    """An anchor detector with the sparse encoder (SECOND, DVSECOND,
    SASSD), ``config`` as shipped, on the workflow's mini KITTI
    (its 16 trainval scenes, the reduced clouds of stage 1, their Car /
    Pedestrian / Cyclist GT, B = ``data.samples_per_gpu``):

    1. one recorded train step of a seeded trainer; every call of
       gather_gemm_conv (12 forward, 7 SubM input gradients),
       gather_gemm_dw (12) and gather_rows (4) replayed against its plain
       version within the gates of its dtype (f32: the same bits on a
       second call) and timed per (K, C, D), gather_rows on a cold L2;
       the eval-mode BEV and head maps with the kernels against the plain
       versions; one whole step with kernels against plain;
    2. main path: ``train_supervised`` for ``steps`` steps (2 an epoch, a
       checkpoint at each epoch's end), exact launches a step (19 / 12 /
       4, nothing else), CUDA events around each step and at its stage
       marks; gates: finite losses (``log_keys`` logged too) with
       positives, each step's lr (the cyclic schedule: the CLI reads only
       lr, weight decay, clip and betas), every parameter and BN statistic
       moved, the head maps and decode from the newest checkpoint equal
       to the in-memory weights' bit for bit; with ``profile`` a profile
       of one more step;
    3. ``infer_anchor`` on the 8 val scenes (12 launches a forward, no
       auxiliary branch) and ``kitti_eval`` on its detections.
    Returns the path's numbers and its replayed kernel rows."""
    import os
    import pickle

    from gga_tpu_torch import apis
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.eval.kitti_eval import kitti_eval
    from gga_tpu_torch.eval.submission import detections_to_kitti_annos
    from gga_tpu_torch.ops import sparse as sp
    from gga_tpu_torch.train import checkpoints as ckpt
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    sparse_conv, gr, _ = mods

    data = os.path.join(tmp, 'kitti')
    cfg, model_cfg, batch, dataset, b0 = supervised_data(torch, data, config)
    d = cfg.data
    print(f'{label}: {type(model_cfg).__name__} of {Path(config).name} '
          f'(grid {model_cfg.sparse_shape}, {model_cfg.max_voxels} voxels, '
          f'encoder {model_cfg.encoder_channels}) on the mini KITTI\'s '
          f'{len(dataset)} trainval scenes, B = {batch} x {d.max_points} '
          'points, f32')
    res = {}

    # --- 1. one recorded step: every kernel call against its plain version
    trainer = apis.init_anchor_trainer(model_cfg, 10, device=DEVICE,
                                       seed=cfg.seed)
    logs0, rec, _ = recorded_step(torch, apis, sp, mods, trainer, b0,
                                  step_fn=apis.anchor_train_step)
    finite_logs(torch, logs0, f'{label} recorded step')
    n_rec = {k: len(v) for k, v in rec.items()}
    want = {k: SUP_PER_STEP[k] for k in n_rec}
    if n_rec != want:
        fail(f'{label} recorded step: kernel calls {n_rec}, expected {want}')
    torch.set_grad_enabled(False)
    conv_rows, dwr, _ = train_kernel_rows(
        torch, sparse_conv, rec, f'{label} kernels', SUP_CONVS, SUP_DGRAD)
    # SECOND's gather sources (at most 16 000 x 64 f32) fit in the L2, so
    # a warm replay reads them from there, faster than the HBM bound: its
    # replays run on a cold L2
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    gr_rows = rows_rows(torch, gr, [a for _, a in rec['gather_rows']], False,
                        f'{label} kernels', flush)
    del flush, rec
    res['plain_comparison'] = anchor_plain_comparison(
        torch, mods, trainer.model, b0['points'], b0['points_valid'])
    torch.set_grad_enabled(True)
    print(f'{label} kernel vs plain forward (eval mode): ' + ', '.join(
        f'{k} err {v["max_abs_err"]:.4g} (max {v["max_abs_plain"]:.4g})'
        for k, v in res['plain_comparison'].items()))
    cmp_step = step_comparison(torch, mods, trainer, b0, anchor_loss,
                               SUP_CONVS)
    print_step_comparison(f'{label} whole step kernels vs plain', cmp_step)
    res.update(step_comparison=cmp_step, recorded_logs={
        k: float(v) for k, v in logs0.items()})
    del trainer, b0
    torch.cuda.empty_cache()

    # --- 2. the main path: the CLI --------------------------------------
    work = os.path.join(tmp, f'work_{label.replace(" ", "_")}')
    summ, trainer = supervised_run(
        torch, mods, card, [config, '--work-dir', work, '--max-steps',
                            str(steps), '--device', DEVICE,
                            *supervised_options(data)],
        SUP_PER_STEP, batch, label)
    missing = [k for k in log_keys if k not in summ['lines'][0]]
    if missing:
        fail(f'{label}: the train log has no {missing}')
    sched = cyclic_cos_schedule(cfg.optimizer.lr, total_steps=steps)
    for ln in summ['lines']:
        want = sched(ln['step'] - 1)
        if not abs(ln['lr'] - want) <= 1e-12 * want:
            fail(f'{label}: step {ln["step"]} ran at lr {ln["lr"]}, the '
                 f'schedule gives {want}')
    n_par, n_bn = moved_from_init(torch, apis, model_cfg, trainer, label,
                                  cfg.seed)
    print(f'{label}: all {n_par} parameter tensors and {n_bn} BN '
          'statistics moved; occupancy_out a step '
          f'{[round(v, 4) for v in summ["occupancy_out"]]}')
    ckpt_dir = summ['ckpt_dir']
    saved = sorted(int(f[5:-3]) for f in os.listdir(ckpt_dir))
    per = summ['steps_per_epoch']
    if saved != sorted({min(e, steps) for e in range(
            per, steps + per, per)}) or len(saved) < 2:
        fail(f'{label}: checkpoints at steps {saved}, {per} steps an epoch')
    t0 = time.perf_counter()
    state = ckpt.load_variables(ckpt_dir)
    load_ms = (time.perf_counter() - t0) * 1e3
    with open(os.path.join(data, SUP_VAL_INFO), 'rb') as f:
        val_infos = pickle.load(f)
    val = KittiDetDataset(data, os.path.join(data, SUP_VAL_INFO),
                          pc_range=cfg.point_cloud_range,
                          pts_prefix=d.pts_prefix, max_points=d.max_points,
                          test_mode=True)
    vb = next(val.epoch_batches(SUP_EVAL_BATCH, shuffle=False))
    live_b = apis.DetectorBundle(trainer.model, model_cfg,
                                 torch.device(DEVICE))
    bundle = apis.init_anchor_detector(model_cfg, state, device=DEVICE)
    outs = []
    for b_ in (live_b, bundle):
        with torch.no_grad():
            maps = b_.model.eval()(
                torch.as_tensor(vb['points'], device=DEVICE),
                torch.as_tensor(vb['points_valid'], device=DEVICE))
        outs.append(dict(maps, **{
            f'decode.{k}': v for k, v in apis.infer_anchor(
                b_, vb['points'], vb['points_valid']).items()}))
    for key, v in outs[0].items():
        if not bits_equal(torch, v, outs[1][key]):
            fail(f'{label}: {key} from step_{steps}.pt differs from the '
                 'in-memory weights')
    print(f'{label}: the head maps and decode of {SUP_EVAL_BATCH} val '
          f'scenes from step_{steps}.pt equal the in-memory weights\' '
          f'bit for bit ({int(outs[0]["decode.valid"].sum())} kept boxes)')
    print(f'{card}: {label} checkpoints: '
          f'{summ["ckpt_bytes"] / 2 ** 20:.1f} MiB each, save ms '
          f'{[round(v, 1) for v in summ["ckpt_save_ms"]]}, load '
          f'{load_ms:.1f} ms')
    res.update(train={k: v for k, v in summ.items() if k != 'lines'},
               losses=[ln['loss'] for ln in summ['lines']],
               lrs=[ln['lr'] for ln in summ['lines']],
               num_pos=[ln['num_pos'] for ln in summ['lines']],
               logs=summ['lines'], ckpt_load_ms=load_ms)
    if profile:
        # one more step of the CLI's trainer under the profiler: busy
        # share and the kernels with the most device time
        b1 = next(dataset.epoch_batches(batch, seed=1))
        res['profile'] = device_profile(
            torch, lambda: apis.anchor_train_step(trainer, b1))
        print_profile(f'{label} train step', res['profile'])
    del trainer, live_b, outs
    torch.cuda.empty_cache()

    # --- 3. inference on the val scenes and the KITTI eval ---------------
    detections, ms = [], []
    zero_counts(mods)
    for vb in val.epoch_batches(SUP_EVAL_BATCH, shuffle=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = apis.infer_anchor(bundle, vb['points'], vb['points_valid'])
        end.record()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        ms.append(start.elapsed_time(end))
        for j in range(SUP_EVAL_BATCH):
            v = out['valid'][j]
            detections.append(dict(boxes_3d=out['boxes'][j][v],
                                   scores_3d=out['scores'][j][v],
                                   labels_3d=out['labels'][j][v]))
    got = counts(mods)
    n_fwd = len(ms)
    want = dict(SUP_PER_STEP, gather_gemm_conv=SUP_CONVS * n_fwd,
                gather_gemm_dw=0, gather_rows=0)
    if got != want or len(detections) != len(val_infos):
        fail(f'{label}: infer_anchor launched {got} in {n_fwd} forwards '
             f'over {len(detections)} scenes, expected {want} over '
             f'{len(val_infos)}')
    det_annos = detections_to_kitti_annos(detections, val_infos,
                                          KittiDetDataset.CLASSES)
    _, ap = kitti_eval([i['annos'] for i in val_infos], det_annos,
                       list(KittiDetDataset.CLASSES))
    if 'KITTI/Car_3D_AP11_moderate_strict' not in ap:
        fail(f'{label}: kitti_eval gave no Car 3D AP')
    res['eval'] = dict(scenes=len(detections), forward_ms=ms,
                       scenes_per_s=len(detections) / (sum(ms) / 1e3),
                       detections=sum(len(x['scores_3d'])
                                      for x in detections), launches=got,
                       car_3d_ap11_mod=ap['KITTI/Car_3D_AP11_moderate_strict'])
    print(f'{card}: {label} infer_anchor on {len(detections)} val scenes '
          f'(batches of {SUP_EVAL_BATCH}): {res["eval"]["scenes_per_s"]:.2f} '
          f'scenes/s by CUDA events around each call (forward, decode, NMS), '
          f'{res["eval"]["detections"]} detections; KITTI Car 3D AP11 '
          f'moderate {res["eval"]["car_3d_ap11_mod"]:.4g}; launches {got}')
    del bundle
    torch.cuda.empty_cache()
    res.update(conv_calls=conv_rows, dw_calls=dwr, gather_rows=gr_rows)
    return res


def supervised_phase(torch, mods, card, tmp):
    """The fully supervised KITTI path on the workflow's mini KITTI:
    SECOND as shipped (f32, B = 6, up to 24 000 points a scene) through
    ``anchor_path`` (SUP_STEPS steps, a profile of one more), then
    PointPillars: ``train_supervised`` for SUP_PP_STEPS steps, no kernel
    launch, finite losses with positives, moved weights."""
    import os

    from gga_tpu_torch import apis, tools_lib
    from gga_tpu_torch.config import Config
    res = anchor_path(torch, mods, card, tmp, str(ROOT / SUP_SECOND),
                      'supervised', SUP_STEPS, profile=True)

    # --- PointPillars as shipped through the same CLI --------------------
    data = os.path.join(tmp, 'kitti')
    pp_config = str(ROOT / SUP_PILLARS)
    pp_cfg = Config.fromfile(pp_config)
    pp_summ, pp_trainer = supervised_run(
        torch, mods, card, [pp_config, '--work-dir',
                            os.path.join(tmp, 'work_pointpillars'),
                            '--max-steps', str(SUP_PP_STEPS), '--device',
                            DEVICE, *supervised_options(data)],
        dict.fromkeys(SUP_PER_STEP, 0), pp_cfg.data.samples_per_gpu,
        'supervised PointPillars')
    n_par, n_bn = moved_from_init(
        torch, apis, tools_lib.model_config_from_cfg(pp_cfg), pp_trainer,
        'supervised PointPillars', pp_cfg.seed)
    print(f'supervised PointPillars: all {n_par} parameter tensors and '
          f'{n_bn} BN statistics moved; no kernel launched')
    res['pointpillars'] = {k: v for k, v in pp_summ.items() if k != 'lines'}
    res['pointpillars'].update(
        losses=[ln['loss'] for ln in pp_summ['lines']],
        num_pos=[ln['num_pos'] for ln in pp_summ['lines']])
    return res


# --- the rest of the KITTI voxel detectors: DVSECOND, SASSD and
#     DynamicVoxelNet through the same CLI -------------------------------
VF_PATHS = (
    ('dvsecond', 'configs/dynamic_voxelization/'
     'dv_second_secfpn_2x8_cosine_80e_kitti-3d-3class.py'),
    ('sassd', 'configs/sassd/sassd_6x8_80e_kitti-3d-3class.py'))
VF_DV_PILLARS = ('configs/dynamic_voxelization/'
                 'dv_pointpillars_secfpn_6x8_160e_kitti-3d-car.py')
VF_STEPS = 3                # --max-steps: 2 an epoch at B = 6, so across one
VF_PP_STEPS = 2             # DynamicVoxelNet's --max-steps
SASSD_AUX = ('aux_loss_cls', 'aux_loss_reg')


def step_peak(torch, apis, model_cfg, batch, seed):
    """Peak ``max_memory_allocated`` of one anchor train step of a fresh
    seeded trainer (weights and optimizer state included)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = apis.init_anchor_trainer(model_cfg, 10, device=DEVICE,
                                       seed=seed)
    finite_logs(torch, apis.anchor_train_step(trainer, batch), 'peak step')
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del trainer
    torch.cuda.empty_cache()
    return peak


@contextlib.contextmanager
def scatter_passes(passes):
    """Record the passes of every ``dynamic_scatter_mean`` call of the
    dynamic detectors (the most points a voxel holds, ``ops/scatter.py``)
    into the list ``passes``."""
    from gga_tpu_torch.models.detectors import dynamic_voxelnet as dv
    real = dv.dynamic_scatter_mean

    def counted(*args):
        means, cnt = real(*args)
        passes.append(int(cnt.max()))
        return means, cnt

    dv.dynamic_scatter_mean = counted
    try:
        yield passes
    finally:
        dv.dynamic_scatter_mean = real


def voxel_family_phase(torch, mods, card, tmp):
    """The rest of the KITTI voxel detectors, each config as shipped, on
    the workflow's mini KITTI (B = ``data.samples_per_gpu`` = 6, up to
    24 000 points a scene, random seeded weights):

    1. DVSECOND (the dv_second 2x8 cosine config: the CLI reads only lr,
       weight decay, clip and betas, so it trains on the cyclic schedule
       at B = 6, as gga_tpu's) and SASSD, its two auxiliary losses finite
       and logged, f32, each through ``anchor_path`` (replays, the
       forward and the whole step against plain, VF_STEPS CLI steps with
       exact launches 19 / 12 / 4, each step's lr, the checkpoint bit for
       bit, a profile of one more step, ``infer_anchor`` +
       ``kitti_eval``);
    2. SASSD's peak memory over one train step with its auxiliary branch
       and without it (SECOND on the same config);
    3. DynamicVoxelNet (dv_pointpillars car config), f32: the CLI for
       VF_PP_STEPS steps with no kernel launch, moved weights,
       ``infer_anchor`` on the val scenes (no launch); the passes of
       ``dynamic_scatter_mean`` (its largest pillar's point count) a
       forward, and DVSECOND's, printed."""
    import dataclasses
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.models.detectors.voxelnet import SECONDNetConfig
    data = os.path.join(tmp, 'kitti')
    res = {}
    t0 = time.perf_counter()
    passes = []
    for tag, config in VF_PATHS:
        with scatter_passes(passes):
            res[tag] = anchor_path(
                torch, mods, card, tmp, str(ROOT / config), tag, VF_STEPS,
                profile=True, log_keys=SASSD_AUX if tag == 'sassd' else ())
        if tag == 'dvsecond':
            res[tag]['scatter_passes'] = passes[:]
            print(f'dvsecond: dynamic_scatter_mean took {max(passes)} passes '
                  f'at most over {len(passes)} forwards (the most points a '
                  '0.05 x 0.05 x 0.1 m voxel holds)')
        torch.cuda.empty_cache()

    # --- SASSD's peak memory with and without its auxiliary branch -------
    cfg, model_cfg, _, _, b0 = supervised_data(
        torch, data, str(ROOT / dict(VF_PATHS)['sassd']))
    second_cfg = SECONDNetConfig(**{
        f.name: getattr(model_cfg, f.name)
        for f in dataclasses.fields(SECONDNetConfig)})
    peaks = dict(with_aux=step_peak(torch, apis, model_cfg, b0, cfg.seed),
                 without_aux=step_peak(torch, apis, second_cfg, b0,
                                       cfg.seed))
    res['sassd']['peak_bytes'] = peaks
    print(f'{card}: sassd: peak memory of one train step at B = '
          f'{b0["points"].shape[0]}: {peaks["with_aux"] / 2 ** 30:.2f} GiB '
          f'with the auxiliary branch, {peaks["without_aux"] / 2 ** 30:.2f} '
          'GiB without it (SECOND on the same config)')
    del b0

    # --- DynamicVoxelNet: no kernel on its path ---------------------------
    # its config is a car one: KittiDetDataset labels Car 2 whatever the
    # config's class_names (as gga_tpu's), so the one-class head's class 0
    # matches the Pedestrian GT, which no car anchor overlaps enough to
    # turn positive: every step has no positive, and no gradient reaches
    # the box and direction convs' zero biases
    pp_config = str(ROOT / VF_DV_PILLARS)
    pp_cfg, pp_model_cfg, pp_batch, _, _ = supervised_data(torch, data,
                                                           pp_config)
    passes = []
    with scatter_passes(passes):
        summ, trainer = supervised_run(
            torch, mods, card, [pp_config, '--work-dir',
                                os.path.join(tmp, 'work_dv_pointpillars'),
                                '--max-steps', str(VF_PP_STEPS), '--device',
                                DEVICE, *supervised_options(data)],
            dict.fromkeys(SUP_PER_STEP, 0), pp_batch, 'dynamic_voxelnet',
            positives=False)
        n_par, n_bn = moved_from_init(
            torch, apis, pp_model_cfg, trainer, 'dynamic_voxelnet',
            pp_cfg.seed, unreached=('bbox_head.conv_reg.bias',
                                    'bbox_head.conv_dir_cls.bias'))
        bundle = apis.DetectorBundle(trainer.model, pp_model_cfg,
                                     torch.device(DEVICE))
        val = KittiDetDataset(data, os.path.join(data, SUP_VAL_INFO),
                              pc_range=pp_cfg.point_cloud_range,
                              pts_prefix=pp_cfg.data.pts_prefix,
                              max_points=pp_cfg.data.max_points,
                              test_mode=True)
        zero_counts(mods)
        kept = 0
        for vb in val.epoch_batches(SUP_EVAL_BATCH, shuffle=False):
            out = apis.infer_anchor(bundle, vb['points'], vb['points_valid'])
            if not torch.isfinite(out['boxes']).all():
                fail('dynamic_voxelnet: infer_anchor gave non-finite boxes')
            kept += int(out['valid'].sum())
        got = counts(mods)
    if any(got.values()):
        fail(f'dynamic_voxelnet: infer_anchor launched {got}')
    res['dynamic_voxelnet'] = {k: v for k, v in summ.items() if k != 'lines'}
    res['dynamic_voxelnet'].update(
        losses=[ln['loss'] for ln in summ['lines']],
        num_pos=[ln['num_pos'] for ln in summ['lines']],
        scatter_passes=passes, eval_kept=kept)
    print(f'dynamic_voxelnet: the {n_par} parameter tensors (the box and '
          f'direction biases, which no gradient reaches, aside) and {n_bn} '
          f'BN statistics moved, num_pos {res["dynamic_voxelnet"]["num_pos"]}'
          f' (the car config\'s head against label 0), no kernel launched; '
          f'infer_anchor kept {kept} boxes on the val scenes; '
          f'dynamic_scatter_mean took {passes} passes a forward (the most '
          'points a 0.16 m pillar holds)')
    del trainer, bundle
    torch.cuda.empty_cache()
    res['seconds'] = time.perf_counter() - t0
    print(f'voxel family phase: {res["seconds"]:.1f} s')
    return res


# --- the fully supervised nuScenes CenterPoint: the 0.1 m voxel config,
#     the 0.075 m DCN circle-NMS config and the 0.2 m pillar DCN config --
CP_CONFIG = ('configs/centerpoint/'
             'centerpoint_01voxel_second_secfpn_4x8_cyclic_20e_nus.py')
CP_SIDE = (
    ('centerpoint 0075 dcn circle', 'configs/centerpoint/centerpoint_0075'
     'voxel_second_secfpn_dcn_circlenms_4x8_cyclic_20e_nus.py'),
    ('centerpoint pillar dcn', 'configs/centerpoint/centerpoint_02pillar_'
     'second_secfpn_dcn_4x8_cyclic_20e_nus.py'))
CP_SPLITS = (8, 4)          # train, val key frames of the mini nuScenes
CP_SWEEPS = 10              # past sweeps a key frame, 0.05 s apart
CP_BEAMS, CP_AZIMUTHS = 32, 1085    # one 32-beam sweep: 34 720 returns
CP_STEPS = 4                # train steps of the 0.1 m voxel config
CP_SIDE_STEPS = 2           # of each side config
# the conv_module encoder of the voxel configs: conv_input, stage 0's
# SubM, two SubM in stages 1 and 2, one in stage 3 (7 SubM), the strided
# convs opening stages 1-3 and conv_out (4 strided); every SubM but
# conv_input takes an input gradient through gather_gemm_conv, the
# strided convs through gather_rows; one heatmap launch a step
CP_CONVS, CP_DGRAD, CP_STRIDED = 11, 6, 4
CP_PER_STEP = dict(gather_gemm_conv=CP_CONVS + CP_DGRAD,
                   gather_gemm_dw=CP_CONVS, gather_rows=CP_STRIDED,
                   gather_rows_t=0, render_heatmap=1)
CP_STAGES = ('voxelize+encoder', 'backbone+neck+head', 'targets+loss',
             'backward', 'clip+AdamW')
# nuScenes-like (dx, dy, dz) and top speed in m/s of the ten classes
CP_CLASSES = dict(car=((4.6, 1.9, 1.7), 12.0), truck=((6.9, 2.5, 2.8), 10.0),
                  trailer=((12.0, 2.9, 3.9), 8.0), bus=((11.0, 2.9, 3.5), 9.0),
                  construction_vehicle=((6.4, 2.8, 3.2), 2.0),
                  bicycle=((1.7, 0.6, 1.3), 4.0),
                  motorcycle=((2.1, 0.8, 1.5), 8.0),
                  pedestrian=((0.7, 0.7, 1.8), 1.5),
                  traffic_cone=((0.4, 0.4, 1.1), 0.0),
                  barrier=((2.5, 0.5, 1.0), 0.0))
CP_GROUND_Z = -1.84         # the ground in the lidar frame


def rot_z(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def lidar_sweep(rng, origin, yaw, boxes):
    """One 32-beam sweep (elevations -30 to +10 degrees, CP_AZIMUTHS
    steps) from a sensor at ``origin`` turned by ``yaw``, in the frame
    the boxes (gravity-centre [N, 7]) are given in: each ray returns
    from the nearest box it meets, the ground, or a wall 40-70 m away.
    Returns (points [n, 5] (x, y, z, intensity, ring) in the sensor's own
    frame, index of the box each point hit or -1)."""
    el = np.deg2rad(np.linspace(-30, 10, CP_BEAMS))[:, None]
    az = np.linspace(-np.pi, np.pi, CP_AZIMUTHS, endpoint=False)[None]
    d_sensor = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                         np.sin(el) * np.ones_like(az)], -1).reshape(-1, 3)
    rot = rot_z(yaw)
    d = d_sensor @ rot.T
    o = np.asarray(origin, np.float64)
    t = rng.uniform(40, 70, len(d))
    down = d[:, 2] < 0
    t_ground = np.where(down, (CP_GROUND_Z - o[2]) / np.where(down, d[:, 2],
                                                              -1), np.inf)
    t = np.minimum(t, t_ground)
    hit = np.full(len(d), -1)
    for k, b in enumerate(boxes):
        rb = rot_z(b[6])
        p = (o - b[:3]) @ rb                      # origin in the box frame
        q = d @ rb
        half = b[3:6] / 2
        with np.errstate(divide='ignore', invalid='ignore'):
            t1 = (-half - p) / q
            t2 = (half - p) / q
        t_in = np.nanmax(np.minimum(t1, t2), -1)
        t_out = np.nanmin(np.maximum(t1, t2), -1)
        meets = (t_out >= np.maximum(t_in, 0)) & (t_in > 0) & (t_in < t)
        t = np.where(meets, t_in, t)
        hit = np.where(meets, k, hit)
    pts = o + t[:, None] * d + rng.normal(0, 0.02, d.shape)
    local = (pts - o) @ rot                     # into the sensor's frame
    ring = np.repeat(np.arange(CP_BEAMS), CP_AZIMUTHS).astype(np.float64)
    cloud = np.concatenate([local, rng.rand(len(d), 1) * 100,
                            ring[:, None]], 1).astype(np.float32)
    return cloud, hit


def mini_nuscenes_boxes(rng):
    """20-40 boxes of the ten classes around the ego (gravity-centre
    lidar boxes [N, 7], names, velocities [N, 2])."""
    names = list(CP_CLASSES)
    boxes, labels, vels = [], [], []
    for _ in range(rng.randint(20, 41)):
        for _ in range(50):       # a free spot
            name = names[rng.randint(len(names))]
            (dx, dy, dz), top = CP_CLASSES[name]
            r, a = rng.uniform(5, 48), rng.uniform(-np.pi, np.pi)
            c = np.array([r * np.cos(a), r * np.sin(a)])
            if all(np.linalg.norm(c - b[:2]) > (dx + b[3]) / 2 + 0.5
                   for b in boxes):
                break
        yaw = rng.uniform(-np.pi, np.pi)
        speed = rng.uniform(0, top)
        boxes.append(np.array([c[0], c[1], CP_GROUND_Z + dz / 2, dx, dy, dz,
                               yaw]))
        labels.append(name)
        vels.append(speed * np.array([np.cos(yaw), np.sin(yaw)]))
    return np.array(boxes), np.array(labels), np.array(vels)


def write_mini_nuscenes(root, splits, n_sweeps=CP_SWEEPS, seed=0):
    """A mini nuScenes under ``root`` in the format the info pkls of
    mmdet3d's converter give: per key frame a lidar .bin (x, y, z,
    intensity, ring as float32, nuScenes' five columns) and
    ``n_sweeps`` past sweeps 0.05 s apart, taken from the moving ego
    (8 m/s, turning 0.05 rad/s) with their sensor-to-lidar transforms,
    of objects that moved with their velocities; 20-40 boxes of the ten
    classes with velocities, lidar point counts and the lidar2ego /
    ego2global transforms; ``nuscenes_infos_train.pkl`` and
    ``nuscenes_infos_val.pkl``. Returns the points of a key frame's
    sweeps, summed over all frames."""
    import os
    import pickle
    rng = np.random.RandomState(seed)
    for sub in ('samples', 'sweeps'):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    n_points, frame = 0, 0
    for split, n in zip(('train', 'val'), splits):
        infos = []
        for _ in range(n):
            boxes, names, vels = mini_nuscenes_boxes(rng)
            ts = 1_000_000 + 500_000 * frame
            cloud, hit = lidar_sweep(rng, (0.0, 0.0, 0.0), 0.0, boxes)
            path = os.path.join('samples', f'{split}_{frame:03d}.bin')
            cloud.tofile(os.path.join(root, path))
            n_points += len(cloud)
            sweeps = []
            for k in range(1, n_sweeps + 1):
                dt = 0.05 * k
                origin = np.array([-8.0 * dt, 0.0, 0.0])
                yaw = -0.05 * dt
                moved = boxes.copy()
                moved[:, :2] -= vels * dt
                sw, _ = lidar_sweep(rng, origin, yaw, moved)
                sw_path = os.path.join('sweeps',
                                       f'{split}_{frame:03d}_{k}.bin')
                sw.tofile(os.path.join(root, sw_path))
                n_points += len(sw)
                sweeps.append(dict(data_path=sw_path,
                                   timestamp=ts - 50_000 * k,
                                   sensor2lidar_rotation=rot_z(yaw),
                                   sensor2lidar_translation=origin))
            count = np.bincount(hit[hit >= 0], minlength=len(boxes))
            infos.append(dict(
                token=f'{split}_{frame:03d}', lidar_path=path, timestamp=ts,
                sweeps=sweeps, gt_boxes=boxes, gt_names=names,
                gt_velocity=vels, num_lidar_pts=count, valid_flag=count > 0,
                lidar2ego_rotation_matrix=np.eye(3),
                lidar2ego_translation=np.array([0.94, 0.0, 1.84]),
                ego2global_rotation_matrix=rot_z(0.3 * frame),
                ego2global_translation=np.array([400.0 + 10 * frame,
                                                 1100.0, 0.0])))
            frame += 1
        with open(os.path.join(root, f'nuscenes_infos_{split}.pkl'),
                  'wb') as f:
            pickle.dump(dict(infos=infos, metadata=dict(version='mini')), f)
    return n_points


def centerpoint_loss_fn(model, batch):
    """The supervised loss of one train-mode forward."""
    from gga_tpu_torch.models.detectors.centerpoint import centerpoint_loss
    preds = model(batch['points'], batch['points_valid'])
    return centerpoint_loss(model.cfg, preds, batch['gt_boxes'],
                            batch['gt_labels'], batch['gt_valid'])[0]


def check_calls(torch, mods, rec, label):
    """Every recorded call of a step against its plain version, at the f32
    gates (conv 1e-5, dW 2e-5 of max|plain|, both the same bits on a
    second call; gathers exact; heatmaps 1e-6 with the same pixels at
    1.0). Returns the largest error of each kernel."""
    sparse_conv, gr, heatmap = mods
    gates = GATES['float32']
    errs = dict.fromkeys(('gather_gemm_conv', 'gather_gemm_dw', 'gather_rows',
                          'render_heatmap'), 0.0)
    with torch.no_grad():
        for i, (_, (f, nmap, w)) in enumerate(rec['gather_gemm_conv']):
            out = sparse_conv.gather_gemm_conv(f, nmap, w)
            ok, err = within_tolerance(
                torch, out, sparse_conv.gather_gemm_conv_plain(f, nmap, w),
                gates['conv'])
            if not ok or not torch.equal(out, sparse_conv.gather_gemm_conv(
                    f, nmap, w)):
                fail(f'{label}: gather_gemm_conv call {i} (K, C, D) = '
                     f'{tuple(w.shape)}: max abs err {err}, or other bits '
                     'on a second call')
            errs['gather_gemm_conv'] = max(errs['gather_gemm_conv'], err)
        for i, (_, (f, nmap, dout)) in enumerate(rec['gather_gemm_dw']):
            out = sparse_conv.gather_gemm_dw(f, nmap, dout)
            ok, err = within_tolerance(
                torch, out, sparse_conv.gather_gemm_dw_plain(f, nmap, dout),
                gates['dw'])
            if not ok or not torch.equal(out, sparse_conv.gather_gemm_dw(
                    f, nmap, dout)):
                fail(f'{label}: gather_gemm_dw call {i} {tuple(out.shape)}: '
                     f'max abs err {err}, or other bits on a second call')
            errs['gather_gemm_dw'] = max(errs['gather_gemm_dw'], err)
        for i, (_, (src, idx)) in enumerate(rec['gather_rows']):
            if not torch.equal(gr.gather_rows(src, idx),
                               gr.gather_rows_plain(src, idx)):
                fail(f'{label}: gather_rows call {i} differs from plain')
        for i, (_, (centers, radii, valid, hw)) in enumerate(
                rec['render_heatmap']):
            out = heatmap.render_heatmap(centers, radii, valid, hw)
            ref = heatmap.render_heatmap_plain(centers, radii, valid, hw)
            err = float((out - ref).abs().max())
            if not err <= 1e-6 or not torch.equal(out == 1.0, ref == 1.0):
                fail(f'{label}: render_heatmap call {i} max abs err {err}, '
                     'or other pixels at 1.0')
            errs['render_heatmap'] = max(errs['render_heatmap'], err)
    torch.cuda.synchronize()
    return errs


def site_hooks(model, sites):
    """Forward hooks that append, for every forward of ``model``, the
    active sites a scene: the voxels (the encoder's or scatter's valid
    input) and, on the voxel configs, each strided conv's output."""
    from gga_tpu_torch.models.layers import SparseConvBlock
    enc = model.pts_middle_encoder
    hooks = [enc.register_forward_pre_hook(
        lambda _, args: sites.append([args[2].sum(-1)]))]
    for m in enc.modules():
        if isinstance(m, SparseConvBlock):
            hooks.append(m.register_forward_hook(
                lambda _, __, out: sites[-1].append(out.valid.sum(-1))))
    return hooks


def calibrate_bn(torch, model, batch, forward=None):
    """Set every batch norm's running statistics to those of one train
    batch (momentum 1 for one train-mode forward without gradients:
    ``forward(model, batch)``, by default the model on the batch's
    points), then leave the model in eval mode. After a few steps at
    momentum 0.01 the statistics are still near their init, where the
    eval-mode forward of random weights carries the raw inputs' scale
    (tens of metres) through the net and ``exp()`` of the dim head can
    overflow."""
    norms = [m for m in model.modules() if hasattr(m, 'running_var')]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        if forward is None:
            model(batch['points'], batch['points_valid'])
        else:
            forward(model, batch)
    for m, momentum in zip(norms, saved):
        m.momentum = momentum
    return model.eval()


def centerpoint_path(torch, mods, card, root, config, label, steps,
                     main=False):
    """A CenterPoint config as shipped on the mini nuScenes (f32, B =
    ``data.samples_per_gpu``, up to ``data.max_points`` points of the key
    frame and its sweeps, seeded random weights):

    0. with ``main``, one whole step with kernels against plain at the
       f32 gates, on the seeded initial weights and the first batch,
       before the train steps: cuDNN's kernels leave the trained weights
       different from run to run in their last bits, and at some of
       those states this model's weight gradients move by about 1e-4 of
       cosine between two f32 steps that differ only in rounding, so a
       check there would pass or fail by the run; the initial state is
       the same on every run;
    1. main path: ``steps`` calls of ``apis.centerpoint_train_step`` on
       the config's optimizer (clip, AdamW, the cyclic lr over ``steps``),
       each recorded, with the counts set to 0 just before and read just
       after; exact launches at every step (voxel configs 17 / 11 / 4 / 1,
       pillar 0 / 0 / 0 / 1), CUDA events at the stage marks, finite
       losses, each step's lr, moved weights and BN statistics, active
       sites against every budget, peak memory;
    2. every recorded call of every step against its plain version
       (``check_calls``); with ``main``, step 1's calls also timed beside
       their bounds (gather_rows on a cold L2) and a profile of one more
       step; the side configs' heatmap calls timed;
    3. ``calibrate_bn`` on the first train batch, then
       ``infer_centerpoint`` on the val key frames (11 launches a forward,
       pillar 0; finite boxes), ``format_results``, ``nuscenes_eval`` (its
       mAP and NDS finite; no AP is a gate at random weights).
    Returns the path's numbers and kernel rows."""
    import math
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.nuscenes import NuScenesDataset
    from gga_tpu_torch.eval.nuscenes_eval import nuscenes_eval
    from gga_tpu_torch.models.builder import config_from_dict
    from gga_tpu_torch.models.detectors.centerpoint import CenterPointConfig
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    sparse_conv, gr, heatmap = mods
    t0 = time.perf_counter()
    cfg = Config.fromfile(config)
    model_cfg = config_from_dict(CenterPointConfig, dict(cfg.model))
    d = cfg.data
    voxel = not model_cfg.pillar
    per_step = (CP_PER_STEP if voxel
                else dict(dict.fromkeys(CP_PER_STEP, 0), render_heatmap=1))

    def dataset(info, test_mode):
        return NuScenesDataset(
            root, os.path.join(root, info), max_points=d.max_points,
            max_objs=d.max_objs, sweeps_num=d.sweeps_num,
            load_interval=d.load_interval, with_velocity=d.with_velocity,
            point_cloud_range=tuple(cfg.point_cloud_range),
            test_mode=test_mode, seed=cfg.seed)

    keys = ('points', 'points_valid', 'gt_boxes', 'gt_labels', 'gt_valid')
    train = dataset(d.train_info, False)
    batch = d.samples_per_gpu
    batches = []
    for epoch in range(math.ceil(steps / (len(train) // batch))):
        train.epoch = epoch
        batches += [{k: torch.as_tensor(b[k], device=DEVICE) for k in keys}
                    for b in train.epoch_batches(batch, seed=epoch)]
    batches = batches[:steps]
    grid = (f'grid {model_cfg.sparse_shape}' if voxel
            else f'pillars {model_cfg.scatter_shape}')
    print(f'{label}: {Path(config).name} ({grid}'
          f', {model_cfg.max_voxels} voxels, DCN head {model_cfg.dcn_head}, '
          f'{model_cfg.nms_type} NMS) on the mini nuScenes\'s {len(train)} '
          f'train key frames, B = {batch} x {d.max_points} points of '
          f'{d.sweeps_num + 1} sweeps, f32; batches loaded in '
          f'{time.perf_counter() - t0:.1f} s')

    o = cfg.optimizer
    trainer = apis.init_centerpoint_trainer(model_cfg, steps, device=DEVICE,
                                            seed=cfg.seed, optimizer=dict(o))
    model = trainer.model
    # --- 0. the whole step against plain, on the initial weights --------
    if main:
        cmp_step = step_comparison(torch, mods, trainer, batches[0],
                                   centerpoint_loss_fn, CP_CONVS)
        print_step_comparison(f'{label} whole step kernels vs plain (initial'
                              ' weights)', cmp_step)

    # --- 1. the main path: recorded train steps -------------------------
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    sites, recs, events, all_logs, lrs = [], [], [], [], []
    hooks = site_hooks(model, sites)
    order = ('encoder', 'forward', 'loss', 'backward', 'optimizer')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    for b in batches:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        stage = ['forward']

        def mark(name, ev=ev, stage=stage):
            ev[order.index(name) + 1].record()
            stage[0] = 'backward' if name in ('loss', 'backward') else \
                stage[0]

        with contextlib.ExitStack() as stack:
            rec = {name: stack.enter_context(recording(
                mod, name, lambda stage=stage: stage[0]))
                for mod, name in ((sparse_conv, 'gather_gemm_conv'),
                                  (sparse_conv, 'gather_gemm_dw'),
                                  (gr, 'gather_rows'), (gr, 'gather_rows_t'),
                                  (heatmap, 'render_heatmap'))}
            ev[0].record()
            all_logs.append(apis.centerpoint_train_step(trainer, b, mark))
        recs.append(rec)
        events.append(ev)
        lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
    torch.cuda.synchronize()
    got = counts(mods)
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    want = {k: v * steps for k, v in per_step.items()}
    if got != want:
        fail(f'{label}: {steps} train steps launched {got}, expected {want}')
    for i, rec in enumerate(recs):
        n = {k: len(v) for k, v in rec.items()}
        if n != per_step:
            fail(f'{label}: step {i + 1} launched {n}, expected {per_step}')
        fwd = [ph for ph, _ in rec['gather_gemm_conv']]
        if voxel and fwd != ['forward'] * CP_CONVS + ['backward'] * CP_DGRAD:
            fail(f'{label}: step {i + 1}: conv calls by stage {fwd}')
    sched = cyclic_cos_schedule(o.lr, tuple(o.lr_target_ratio),
                                o.step_ratio_up, steps)
    for i, (lg, lr) in enumerate(zip(all_logs, lrs)):
        finite_logs(torch, lg, f'{label} step {i + 1}')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'{label}: step {i + 1} ran at lr {lr}, the schedule gives '
                 f'{sched(i)}')
    # the conv biases before a train-mode BN have a zero gradient up to
    # rounding; every other parameter and every BN statistic must move
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n]) and not n.endswith('.conv.bias')]
    bn_stuck = [n for n, b in model.named_buffers()
                if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
    if stuck or bn_stuck:
        fail(f'{label}: {len(stuck)} parameter tensors and {len(bn_stuck)} '
             f'BN statistics did not move: {(stuck + bn_stuck)[:8]}')
    del params0, stats0
    step_ms = [ev[0].elapsed_time(ev[5]) for ev in events]
    stage_ms = {name: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                                     for ev in events[1:]]))
                for i, name in enumerate(CP_STAGES)}
    site_names = ['voxels'] + ([f'stage{i}' for i in (1, 2, 3)] + ['out']
                               if voxel else [])
    budgets = [model_cfg.max_voxels] + (
        [*model_cfg.encoder_budgets, model_cfg.encoder_out_budget]
        if voxel else [])
    per_scene = {n: [int(v) for s in sites for v in s[j].tolist()]
                 for j, n in enumerate(site_names)}
    occupancy = {n: dict(budget=bud, mean=float(np.mean(per_scene[n])),
                         max=max(per_scene[n]),
                         saturated=max(per_scene[n]) >= bud)
                 for n, bud in zip(site_names, budgets)}
    res = dict(config=Path(config).name, steps=steps, batch=batch,
               launches=got, step_device_ms=step_ms, stage_ms=stage_ms,
               scenes_per_s_events=batch * (steps - 1) / (sum(step_ms[1:])
                                                          / 1e3),
               peak_bytes=peak, occupancy=occupancy, lrs=lrs,
               losses=[float(lg['loss']) for lg in all_logs],
               grad_norms=[float(lg['grad_norm']) for lg in all_logs])
    print(f'{card}: {label}: {steps} train steps at B={batch} (f32): '
          f'{res["scenes_per_s_events"]:.3f} scenes/s by CUDA events around '
          f'the steps after the first; step device ms '
          f'{[round(v, 1) for v in step_ms]}; by stage (mean after the '
          'first) ' + ', '.join(f'{k} {v:.2f}' for k, v in stage_ms.items())
          + f'; peak memory {peak / 2 ** 30:.2f} GiB; losses '
          f'{[round(v, 3) for v in res["losses"]]}; launches {got}')
    print(f'{label}: active sites a scene against their budgets: ' + ', '.join(
        f'{n} mean {v["mean"]:.0f} max {v["max"]} of {v["budget"]}'
        + (' (SATURATED)' if v['saturated'] else '')
        for n, v in occupancy.items()))

    # --- 2. every recorded call against its plain version ---------------
    torch.set_grad_enabled(False)
    errs = [check_calls(torch, mods, rec, f'{label} step {i + 1}')
            for i, rec in enumerate(recs)]
    res['max_abs_err'] = {k: max(e[k] for e in errs) for k in errs[0]}
    print(f'{label}: every call of the {steps} steps against its plain '
          'version: largest errors ' + ', '.join(
              f'{k} {v:.3g}' for k, v in res['max_abs_err'].items()))
    rec = recs[0]
    res['heatmap'] = heatmap_rows(torch, heatmap, rec['render_heatmap'],
                                  f'{label} kernels')
    if main:
        calls = [a for _, a in rec['gather_gemm_conv']]
        res['conv_calls'] = [conv_row(torch, sparse_conv, *a,
                                      f'{label} call {i}')
                             for i, a in enumerate(calls)]
        print_conv_rows(f'{label} kernels: gather_gemm_conv vs plain at '
                        f'step 1\'s {CP_CONVS} forward and {CP_DGRAD} '
                        'input-gradient calls', res['conv_calls'])
        res['dw_calls'] = dw_rows(torch, sparse_conv, rec['gather_gemm_dw'],
                                  f'{label} kernels')
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                            device=DEVICE)
        res['gather_rows'] = rows_rows(
            torch, gr, [a for _, a in rec['gather_rows']], False,
            f'{label} kernels', flush)
        del flush, calls
    del recs, rec
    torch.set_grad_enabled(True)
    if main:
        res['step_comparison'] = cmp_step
        res['profile'] = device_profile(
            torch, lambda: apis.centerpoint_train_step(trainer, batches[1]))
        print_profile(f'{label} train step', res['profile'])
    calibrate_bn(torch, model, batches[0])
    del batches
    torch.cuda.empty_cache()

    # --- 3. inference on the val key frames and the nuScenes eval -------
    val = dataset(d.val_info, True)
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    detections, ms = [], []
    zero_counts(mods)
    for vb in val.epoch_batches(batch, shuffle=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = apis.infer_centerpoint(bundle, vb['points'], vb['points_valid'])
        end.record()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        ms.append(start.elapsed_time(end))
        for j in range(batch):
            v = out['valid'][j]
            detections.append(dict(boxes_3d=out['boxes'][j][v],
                                   scores_3d=out['scores'][j][v],
                                   labels_3d=out['labels'][j][v]))
    got = counts(mods)
    want = dict.fromkeys(CP_PER_STEP, 0)
    want['gather_gemm_conv'] = CP_CONVS * len(ms) if voxel else 0
    if got != want or len(detections) != len(val):
        fail(f'{label}: infer_centerpoint launched {got} in {len(ms)} '
             f'forwards over {len(detections)} key frames, expected {want} '
             f'over {len(val)}')
    if not all(np.isfinite(x['boxes_3d']).all() for x in detections):
        fail(f'{label}: infer_centerpoint gave non-finite boxes')
    sub = val.format_results(detections)
    if (sorted(sub['results']) != sorted(i['token'] for i in val.data_infos)
            or not all(np.isfinite(a['translation']).all()
                       for annos in sub['results'].values() for a in annos)):
        fail(f'{label}: format_results gave {len(sub["results"])} samples '
             'or non-finite translations')
    preds = [dict(boxes=x['boxes_3d'], scores=x['scores_3d'],
                  names=np.array([val.CLASSES[int(c)]
                                  for c in x['labels_3d']]))
             for x in detections]
    metrics = nuscenes_eval(val.eval_ground_truth(), preds)
    if not all(k in metrics and np.isfinite(metrics[k])
               for k in ('mAP', 'NDS')):
        fail(f'{label}: nuscenes_eval gave no finite mAP / NDS')
    n_det = sum(len(x['scores_3d']) for x in detections)
    res['eval'] = dict(scenes=len(detections), forward_ms=ms,
                       scenes_per_s=len(detections) / (sum(ms) / 1e3),
                       detections=n_det, launches=got, mAP=metrics['mAP'],
                       NDS=metrics['NDS'])
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: infer_centerpoint on {len(detections)} val key '
          f'frames (batches of {batch}): {res["eval"]["scenes_per_s"]:.2f} '
          f'scenes/s by CUDA events around each call (forward, decode, '
          f'{model_cfg.nms_type} NMS), {n_det} detections; format_results '
          f'{len(sub["results"])} samples; nuscenes_eval mAP '
          f'{metrics["mAP"]:.4g}, NDS {metrics["NDS"]:.4g} (random weights); '
          f'launches {got}; the path {res["seconds"]:.1f} s')
    del trainer, model, bundle
    torch.cuda.empty_cache()
    return res


def centerpoint_phase(torch, mods, card, tmp):
    """The fully supervised nuScenes CenterPoint on a mini nuScenes written
    from seed 0 (``write_mini_nuscenes``: 8 train and 4 val key frames of
    10 sweeps each): the 0.1 m voxel config as shipped through
    ``centerpoint_path`` for CP_STEPS steps with its kernels timed, the
    whole step against plain and the eval; then the 0.075 m DCN
    circle-NMS config and the 0.2 m pillar DCN config for CP_SIDE_STEPS
    steps and an inference each."""
    import os
    t0 = time.perf_counter()
    root = os.path.join(tmp, 'nuscenes')
    n_points = write_mini_nuscenes(root, CP_SPLITS)
    frames = sum(CP_SPLITS)
    print(f'centerpoint phase: mini nuScenes of {frames} key frames x '
          f'{CP_SWEEPS + 1} sweeps, {n_points / frames / (CP_SWEEPS + 1):.0f}'
          f' points a sweep, written in {time.perf_counter() - t0:.1f} s')
    res = dict(main=centerpoint_path(torch, mods, card, root,
                                     str(ROOT / CP_CONFIG), 'centerpoint',
                                     CP_STEPS, main=True))
    for label, config in CP_SIDE:
        res[label] = centerpoint_path(torch, mods, card, root,
                                      str(ROOT / config), label,
                                      CP_SIDE_STEPS)
    res['seconds'] = time.perf_counter() - t0
    print(f'centerpoint phase: {res["seconds"]:.1f} s')
    return res


# --- PartA2: SparseUNet with the inverse sparse conv, the RPN and the
#     part-aggregation RoI head ---------------------------------------------
PA_CONFIG = 'configs/parta2/hv_PartA2_secfpn_2x8_cyclic_80e_kitti-3d-3class.py'
PA_STEPS = 3                # the last 2 batches of epoch 0, the first of 1
# SparseUNet: conv_input + stage 0's SubM, a strided conv and 2 SubM in
# each of stages 1-3, conv_out (12 in the encoder), then 4 x (the lateral
# block's 2 SubM, the merge SubM, the inverse conv or, last, a SubM) in
# the decoder (16); every conv but conv_input takes an input gradient
# through gather_gemm_conv (the strided and inverse convs' on their
# swapped maps), none through gather_rows; no heatmap
PA_CONVS, PA_DGRAD = 28, 27
PA_PER_STEP = dict(gather_gemm_conv=PA_CONVS + PA_DGRAD,
                   gather_gemm_dw=PA_CONVS, gather_rows=0, gather_rows_t=0,
                   render_heatmap=0)
PA_STAGES = ('voxelize+UNet', 'BEV+RPN+proposals+RoI pool+RCNN',
             'targets+loss', 'backward', 'clip+AdamW')
PA_EVAL_BATCH = 2           # scenes a forward of infer_parta2
# epoch 0's batches whose whole step is also compared, ungated: where a
# rounding moves a ReLU or a max across a tie, the step's gradients jump
# (ROADMAP.md §3, PartA2), and these two meet such a jump
PA_NOISE_BATCHES = (6, 3)


def parta2_forward(torch, model, batch, seed=5):
    """A train-mode forward of PartA2 on a batch with a seeded draw (the
    RoI sampler's and the dropout masks)."""
    from gga_tpu_torch.models.detectors import parta2 as p2
    draws = p2.parta2_draws(model, batch['points'].shape[0],
                            torch.Generator().manual_seed(seed),
                            batch['points'].device)
    return model(batch['points'], batch['points_valid'], batch['gt_boxes'],
                 batch['gt_labels'], batch['gt_valid'], draws)


@contextlib.contextmanager
def frozen_proposals():
    """The first call's proposals given to every later call of PartA2's
    forward: the proposals are a discrete function of the RPN's scores
    (top-k, NMS), so two forwards whose scores differ by rounding may
    keep other boxes, and the RoIs' pooled cells may then differ too. A
    comparison of the sparse convs holds them fixed."""
    from gga_tpu_torch.models.detectors import parta2 as p2
    real = p2.rpn_proposals
    kept = []

    def frozen(*args, **kwargs):
        if not kept:
            kept.append(real(*args, **kwargs))
        return kept[0]

    p2.rpn_proposals = frozen
    try:
        yield
    finally:
        p2.rpn_proposals = real


@contextlib.contextmanager
def roi_counts(rec):
    """Append to ``rec``, for every PartA2 forward, the proposals each
    scene keeps and, in train mode, its valid and positive sampled RoIs
    (tensors on the card, read after the run)."""
    from gga_tpu_torch.models.detectors import parta2 as p2
    real_p, real_s = p2.rpn_proposals, p2.assign_and_sample

    def props(*args, **kwargs):
        out = real_p(*args, **kwargs)
        rec.append(dict(proposals=out['valid'].sum(-1)))
        return out

    def sample(*args, **kwargs):
        out = real_s(*args, **kwargs)
        rec[-1].update(rois=out['roi_valid'].sum(-1),
                       positives=out['pos_mask'].sum(-1))
        return out

    p2.rpn_proposals, p2.assign_and_sample = props, sample
    try:
        yield rec
    finally:
        p2.rpn_proposals, p2.assign_and_sample = real_p, real_s


def parta2_phase(torch, mods, card, tmp):
    """PartA2 (the 3-class config as shipped: 16 000 voxels of a
    41 x 1600 x 1408 grid, SparseUNet budgets 16 000 / 14 000 / 12 000 and
    12 000 at conv_out, SECOND 128 / 256 + SECONDFPN, an RPN of 512
    features, 512 train / 100 test proposals, 128 sampled RoIs a scene on
    14^3 grids; f32, B = 2, seeded random weights) on the workflow's mini
    KITTI (its 16 trainval scenes, the reduced clouds):

    0. one whole step with kernels against plain, on the seeded initial
       weights and the dataset's first batch (epoch 0's, as every anchor
       path's), cuDNN off (``step_comparison``, the f32 gates; the
       proposals of the kernel step and one seeded draw given to all four
       steps, ``frozen_proposals``); the same four steps on epoch 0's
       PA_NOISE_BATCHES, printed, not gated; and one forward + backward
       with cuDNN on and off timed (the RCNN head's 3-D convs take
       torch's native conv without cuDNN);
    1. main path: PA_STEPS calls of ``apis.parta2_train_step`` on the
       config's optimizer and the schedule of its 80 epochs, as the CLI
       builds them (the last two batches of epoch 0, the first of epoch
       1), each recorded, the counts set to 0 just before and read
       just after: exact launches at every step (55 gather_gemm_conv: 28
       forward, 27 input gradients; 28 gather_gemm_dw; nothing else),
       CUDA events at the stage marks, finite losses, each step's lr,
       every parameter and BN statistic moved (but zero-initialised
       biases that no gradient reached), active sites against every
       budget, peak memory; the proposals kept and the positive RoIs a
       step printed, not gated (random weights may meet none);
    2. every recorded call of every step against its plain version at the
       f32 gates (``check_calls``), step 1's calls timed beside their
       bounds; a profile of one more step;
    3. ``calibrate_bn`` on the first batch, then ``infer_parta2`` on the 8
       val scenes (28 launches a forward, finite boxes).
    Returns the phase's numbers and kernel rows."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.models.detectors.parta2 import parta2_loss
    from gga_tpu_torch.models.layers import (RulebookConv3d, RulebookConvBlock,
                                             SparseInverseConv3d, SubMConv3d)
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    sparse_conv, gr, heatmap = mods
    t0 = time.perf_counter()
    data = os.path.join(tmp, 'kitti')
    cfg, model_cfg, batch, dataset, b0 = supervised_data(
        torch, data, str(ROOT / PA_CONFIG))
    keys = ('points', 'points_valid', 'gt_boxes', 'gt_labels', 'gt_valid')
    b0 = {k: b0[k] for k in keys}
    batches = []
    for epoch in (0, 1):
        dataset.epoch = epoch
        eb = [{k: torch.as_tensor(b[k], device=DEVICE) for k in keys}
              for b in dataset.epoch_batches(batch, seed=epoch)]
        batches += eb[len(eb) - PA_STEPS + 1:] if epoch == 0 else eb[:1]
        if epoch == 0:
            noise_batches = [eb[i] for i in PA_NOISE_BATCHES]
    d = cfg.data
    print(f'parta2: {Path(PA_CONFIG).name} (grid {model_cfg.sparse_shape}, '
          f'{model_cfg.max_voxels} voxels, UNet budgets '
          f'{model_cfg.unet_budgets} / {model_cfg.unet_out_budget}, '
          f'{model_cfg.train_proposals} train proposals, '
          f'{model_cfg.roi.num_rois} RoIs of {model_cfg.roi.roi_out_size}^3)'
          f' on the mini KITTI\'s {len(dataset)} trainval scenes, B = '
          f'{batch} x {d.max_points} points, f32')
    o = cfg.optimizer
    # the schedule of the CLI's run of the config (80 epochs), whose
    # first steps these are
    total = len(dataset) // batch * cfg.max_epochs
    trainer = apis.init_parta2_trainer(
        model_cfg, total, device=DEVICE, seed=cfg.seed,
        optimizer=dict(lr=o.lr, weight_decay=o.weight_decay,
                       grad_clip=o.grad_clip,
                       betas=tuple(o.get('betas', (0.95, 0.99)))))
    model = trainer.model
    res = dict(config=Path(PA_CONFIG).name, steps=PA_STEPS, batch=batch,
               total_steps=total)

    # --- 0. the whole step against plain, on the initial weights --------
    def loss_fn(m, b):
        with frozen_proposals():
            out = parta2_forward(torch, m, b)
        return parta2_loss(m.cfg, out, b['gt_boxes'], b['gt_labels'],
                           b['gt_valid'])[0]

    t = time.perf_counter()
    with frozen_proposals():
        cmp_step = step_comparison(
            torch, mods, trainer, b0, loss_fn, PA_CONVS,
            conv_types=(SubMConv3d, RulebookConv3d, SparseInverseConv3d))
    cmp_step['seconds'] = time.perf_counter() - t
    print_step_comparison('parta2 whole step kernels vs plain (initial '
                          'weights, cuDNN off, the proposals of the kernel '
                          'step)', cmp_step)
    noise = []
    for i, b in zip(PA_NOISE_BATCHES, noise_batches):
        with frozen_proposals():
            r = step_comparison(
                torch, mods, trainer, b, loss_fn, PA_CONVS,
                conv_types=(SubMConv3d, RulebookConv3d, SparseInverseConv3d),
                gated=False)
        noise.append(dict(batch=i, **{k: r[k] for k in (
            'min_cosine', 'min_cosine_plain_ulp_noise',
            'min_cosine_plain_reordered', 'loss_rel', 'grad_norm_rel')}))
        print(f'parta2 whole step on epoch 0\'s batch {i}, not gated: 1 - '
              f'cosine kernels {1 - r["min_cosine"]:.3g}, plain with one ulp '
              f'of input noise {1 - r["min_cosine_plain_ulp_noise"]:.3g}, '
              f'plain reordered {1 - r["min_cosine_plain_reordered"]:.3g} '
              '(min over the 28 sparse conv weight gradients)')
    del noise_batches
    cudnn_ms = {}
    for on in (True, False):
        with torch.backends.cudnn.flags(enabled=on):
            loss_and_grads(torch, trainer, b0, loss_fn)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            loss_and_grads(torch, trainer, b0, loss_fn)
            ev[1].record()
            torch.cuda.synchronize()
            cudnn_ms['on' if on else 'off'] = ev[0].elapsed_time(ev[1])
    res.update(step_comparison=cmp_step, step_noise=noise,
               loss_and_grads_ms=cudnn_ms)
    print(f'{card}: parta2: one forward + backward (no optimizer) '
          f'{cudnn_ms["on"]:.1f} ms with cuDNN, {cudnn_ms["off"]:.1f} ms '
          f'without (torch\'s native 3-D conv in the RCNN head); the whole '
          f'step comparison took {cmp_step["seconds"]:.1f} s')

    # --- 1. the main path: recorded train steps -------------------------
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    sites, recs, events, all_logs, lrs, rois = [], [], [], [], [], []
    enc = model.middle_encoder
    hooks = [enc.register_forward_pre_hook(
        lambda _, args: sites.append([args[2].sum(-1)]))]
    hooks += [m.register_forward_hook(
        lambda _, __, out: sites[-1].append(out[0].valid.sum(-1)))
        for m in enc.modules() if isinstance(m, RulebookConvBlock)]
    order = ('encoder', 'forward', 'loss', 'backward', 'optimizer')
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    with roi_counts(rois):
        for b in batches:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            stage = ['forward']

            def mark(name, ev=ev, stage=stage):
                ev[order.index(name) + 1].record()
                stage[0] = ('backward' if name in ('loss', 'backward')
                            else stage[0])

            with contextlib.ExitStack() as stack:
                rec = {name: stack.enter_context(recording(
                    mod, name, lambda stage=stage: stage[0]))
                    for mod, name in ((sparse_conv, 'gather_gemm_conv'),
                                      (sparse_conv, 'gather_gemm_dw'),
                                      (gr, 'gather_rows'),
                                      (gr, 'gather_rows_t'),
                                      (heatmap, 'render_heatmap'))}
                ev[0].record()
                all_logs.append(apis.parta2_train_step(trainer, b, mark, {}))
            recs.append(rec)
            events.append(ev)
            lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
    torch.cuda.synchronize()
    got = counts(mods)
    peak = torch.cuda.max_memory_allocated()
    for h in hooks:
        h.remove()
    want = {k: v * PA_STEPS for k, v in PA_PER_STEP.items()}
    if got != want:
        fail(f'parta2: {PA_STEPS} train steps launched {got}, expected '
             f'{want}')
    for i, rec in enumerate(recs):
        n = {k: len(v) for k, v in rec.items()}
        if n != PA_PER_STEP:
            fail(f'parta2: step {i + 1} launched {n}, expected {PA_PER_STEP}')
        by_stage = [ph for ph, _ in rec['gather_gemm_conv']]
        if by_stage != ['forward'] * PA_CONVS + ['backward'] * PA_DGRAD:
            fail(f'parta2: step {i + 1}: conv calls by stage {by_stage}')
    sched = cyclic_cos_schedule(o.lr, total_steps=total)
    for i, (lg, lr) in enumerate(zip(all_logs, lrs)):
        finite_logs(torch, lg, f'parta2 step {i + 1}')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'parta2: step {i + 1} ran at lr {lr}, the schedule gives '
                 f'{sched(i)}')
    # a zero-initialised bias that no gradient reached (the RCNN's box
    # branch without positive RoIs) stays zero under AdamW's decay; every
    # other parameter and every BN statistic must move
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n]) and bool(params0[n].any())]
    unreached = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n]) and not params0[n].any()]
    bn_stuck = [n for n, b in model.named_buffers()
                if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
    if stuck or bn_stuck:
        fail(f'parta2: {len(stuck)} parameter tensors and {len(bn_stuck)} '
             f'BN statistics did not move: {(stuck + bn_stuck)[:8]}')
    del params0, stats0
    step_ms = [ev[0].elapsed_time(ev[5]) for ev in events]
    stage_ms = {name: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                                     for ev in events[1:]]))
                for i, name in enumerate(PA_STAGES)}
    names = ['voxels', 'stage1', 'stage2', 'stage3', 'out']
    budgets = [model_cfg.max_voxels, *model_cfg.unet_budgets,
               model_cfg.unet_out_budget]
    per_scene = {n: [int(v) for s_ in sites for v in s_[j].tolist()]
                 for j, n in enumerate(names)}
    occupancy = {n: dict(budget=bud, mean=float(np.mean(per_scene[n])),
                         max=max(per_scene[n]),
                         saturated=max(per_scene[n]) >= bud)
                 for n, bud in zip(names, budgets)}
    roi_stats = {k: [r[k].tolist() for r in rois]
                 for k in ('proposals', 'rois', 'positives')}
    res.update(launches=got, step_device_ms=step_ms, stage_ms=stage_ms,
               scenes_per_s_events=batch * (PA_STEPS - 1)
               / (sum(step_ms[1:]) / 1e3),
               peak_bytes=peak, occupancy=occupancy, lrs=lrs,
               losses=[float(lg['loss']) for lg in all_logs],
               logs=[{k: float(v) for k, v in lg.items()} for lg in all_logs],
               roi_stats=roi_stats, unreached=unreached)
    print(f'{card}: parta2: {PA_STEPS} train steps at B={batch} (f32): '
          f'{res["scenes_per_s_events"]:.3f} scenes/s by CUDA events around '
          f'the steps after the first; step device ms '
          f'{[round(v, 1) for v in step_ms]}; by stage (mean after the '
          'first) ' + ', '.join(f'{k} {v:.2f}' for k, v in stage_ms.items())
          + f'; peak memory {peak / 2 ** 30:.2f} GiB; losses '
          f'{[round(v, 3) for v in res["losses"]]}; launches {got}')
    print('parta2: active sites a scene against their budgets: ' + ', '.join(
        f'{n} mean {v["mean"]:.0f} max {v["max"]} of {v["budget"]}'
        + (' (SATURATED)' if v['saturated'] else '')
        for n, v in occupancy.items()))
    print(f'parta2: proposals kept a scene {roi_stats["proposals"]}, valid '
          f'RoIs {roi_stats["rois"]}, positive RoIs '
          f'{roi_stats["positives"]} (not gated); RPN positives '
          f'{[lg["rpn_num_pos"] for lg in res["logs"]]}; parameters no '
          f'gradient reached: {unreached}')

    # --- 2. every recorded call against its plain version ---------------
    torch.set_grad_enabled(False)
    errs = [check_calls(torch, mods, rec, f'parta2 step {i + 1}')
            for i, rec in enumerate(recs)]
    res['max_abs_err'] = {k: max(e[k] for e in errs) for k in errs[0]}
    print(f'parta2: every call of the {PA_STEPS} steps against its plain '
          'version: largest errors ' + ', '.join(
              f'{k} {v:.3g}' for k, v in res['max_abs_err'].items()))
    rec = recs[0]
    res['conv_calls'] = [conv_row(torch, sparse_conv, *a, f'parta2 call {i}')
                         for i, (_, a) in enumerate(rec['gather_gemm_conv'])]
    print_conv_rows(f'parta2 kernels: gather_gemm_conv vs plain at step 1\'s '
                    f'{PA_CONVS} forward and {PA_DGRAD} input-gradient calls',
                    res['conv_calls'])
    res['dw_calls'] = dw_rows(torch, sparse_conv, rec['gather_gemm_dw'],
                              'parta2 kernels')
    del recs, rec
    torch.set_grad_enabled(True)
    res['profile'] = device_profile(
        torch, lambda: apis.parta2_train_step(trainer, batches[1]))
    print_profile('parta2 train step', res['profile'])
    calibrate_bn(torch, model, b0, lambda m, b: parta2_forward(torch, m, b))
    del batches, b0
    torch.cuda.empty_cache()

    # --- 3. inference on the val scenes ---------------------------------
    val = KittiDetDataset(data, os.path.join(data, SUP_VAL_INFO),
                          pc_range=cfg.point_cloud_range,
                          pts_prefix=d.pts_prefix, max_points=d.max_points,
                          test_mode=True)
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    ms, kept, props = [], [], []
    zero_counts(mods)
    with roi_counts(props):
        for vb in val.epoch_batches(PA_EVAL_BATCH, shuffle=False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = apis.infer_parta2(bundle, vb['points'], vb['points_valid'])
            end.record()
            if not torch.isfinite(out['boxes']).all():
                fail('parta2: infer_parta2 gave non-finite boxes')
            kept += out['valid'].sum(-1).tolist()
            ms.append(start.elapsed_time(end))
    got = counts(mods)
    want = dict(dict.fromkeys(PA_PER_STEP, 0),
                gather_gemm_conv=PA_CONVS * len(ms))
    if got != want or len(kept) != len(val):
        fail(f'parta2: infer_parta2 launched {got} in {len(ms)} forwards '
             f'over {len(kept)} scenes, expected {want} over {len(val)}')
    res['eval'] = dict(scenes=len(kept), forward_ms=ms,
                       scenes_per_s=len(kept) / (sum(ms) / 1e3), kept=kept,
                       proposals=[p['proposals'].tolist() for p in props],
                       launches=got)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: parta2: infer_parta2 on {len(kept)} val scenes (batches '
          f'of {PA_EVAL_BATCH}): {res["eval"]["scenes_per_s"]:.2f} scenes/s '
          'by CUDA events around each call (forward, test proposals, RoI '
          f'pool, RCNN, decode, NMS); kept boxes a scene {kept}; launches '
          f'{got}; the phase {res["seconds"]:.1f} s')
    del trainer, model, bundle
    torch.cuda.empty_cache()
    return res


# --- the accuracy benches: weak GGA training to pseudo-label AP, then the
#     PGD retrain on those pseudo labels ----------------------------------
ACC_SCENES = 16             # synthetic scenes (make_synth_kitti, seed 0)
ACC_BATCH = 8               # 2 steps an epoch
ACC_STEPS = 400             # weak-train steps of the CLI
ACC_EVAL_EVERY = 200
# the round-5 recipe of gga_tpu's ACCURACY.md on the small model, f32:
# flat lr, PAL backprop and the three loss weights
ACC_LR = 2e-4
ACC_WEIGHTS = dict(dim_prior=3.0, yaw_prior=1.0, containment=1.0)
ACC_FLAGS = ('--cfg', 'small', '--lr', str(ACC_LR), '--flat-lr', '--pal',
             *(x for k, v in ACC_WEIGHTS.items()
               for x in (f'--{k.replace("_", "-")}', str(v))))
ACC_S4_STEPS = 6            # PGD steps on the dump
ACC_S4_REPS = 2             # final stage-4 evals on the same weights
# the stage-1 labels' AP on the ACC_SCENES scenes of seed 0: numpy only,
# equal to gga_tpu's on the CPU (tests/test_torch_accuracy.py)
ACC_STAGE1_AP = dict(AP11_3D_mod=87.19851576994436,
                     AP11_BEV_mod=87.19851576994436,
                     AP11_3D_mod_loose=87.19851576994436,
                     AP11_BEV_mod_loose=87.19851576994436)
# sparse convs of one small-config forward: conv_input + 4 basic blocks
# x 2 + 3 strided + conv_out; the 8 SubM convs after conv_input take an
# input gradient by gather_gemm_conv, the 4 strided ones by gather_rows
ACC_CONVS, ACC_DGRAD, ACC_STRIDED = 13, 8, 4
ACC_PER_STEP = dict(gather_gemm_conv=ACC_CONVS + ACC_DGRAD,
                    gather_gemm_dw=ACC_CONVS, gather_rows=ACC_STRIDED,
                    gather_rows_t=0, render_heatmap=1)


@contextlib.contextmanager
def per_call(module, name, torch, mods):
    """Replace ``module.name`` by a wrapper that records, for each call,
    the kernel launches it made (the counts read before and after, never
    reset), CUDA events around it and its result."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        before = counts(mods)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(*args, **kwargs)
        ev[1].record()
        after = counts(mods)
        calls.append(dict(launches={k: after[k] - before[k] for k in after},
                          events=ev, out=out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def events_ms(torch, calls):
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in (c['events'] for c in calls)]


def accuracy_phase(torch, mods, card, tmp):
    """The accuracy benches on the card (``gga_tpu_torch/tools/
    accuracy_bench.py`` and ``accuracy_bench_stage4.py``):

    1. ACC_SCENES synthetic scenes from seed 0 with their stage-1 labels;
       the labels' AP must equal ACC_STAGE1_AP.
    2. The weak-train step of ACC_FLAGS (GGAModelConfig.small(), f32)
       recorded on the CLI's first batch: every call of gather_gemm_conv
       (13 forward, 8 SubM input gradients), gather_gemm_dw (13),
       gather_rows (4) and render_heatmap (1) replayed against its plain
       version within the f32 gates and timed.
    3. Main path: the CLI for ACC_STEPS steps with an eval every
       ACC_EVAL_EVERY and the pseudo labels dumped; exact launches at
       every step (21 / 13 / 4 / 1) and every forward (13), finite
       losses, the four AP keys untrained and trained; the saved state
       reloaded and evaluated twice gives the CLI's trained AP both times.
    4. The stage-4 CLI on the dump for ACC_S4_STEPS steps: no kernel
       launch, finite losses with positives at each step, the five AP
       keys, ACC_S4_REPS final evals equal.
    Prints the rates (CUDA events around each train step and forward;
    the tools' wall seconds) and the AP values beside the card."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.models.detectors.centerpoint_gga import GGAModelConfig
    from gga_tpu_torch.ops import sparse as sp
    from gga_tpu_torch.tools import accuracy_bench as ab
    from gga_tpu_torch.tools import accuracy_bench_stage4 as s4
    sparse_conv, gr, heatmap = mods
    t_phase = time.perf_counter()
    root = os.path.join(tmp, 'accuracy')
    res = {}

    # --- 1. the scenes and their stage-1 labels --------------------------
    t0 = time.perf_counter()
    infos, info_path = ab.make_synth_kitti(root, ACC_SCENES)
    res['scenes_s'] = time.perf_counter() - t0
    stage1 = ab.score_stage1_labels(infos)
    if stage1 != ACC_STAGE1_AP:
        fail(f'accuracy: stage-1 AP {stage1} on {ACC_SCENES} scenes, the CPU '
             f'pins {ACC_STAGE1_AP}')
    print(f'accuracy: {ACC_SCENES} synthetic scenes and their stage-1 labels '
          f'in {res["scenes_s"]:.1f} s (host); stage-1 AP equals the CPU '
          f'pin: {stage1}')

    # --- 2. the CLI's first step, recorded and replayed --------------------
    cfg = ab.bench_config(GGAModelConfig.small(), pal=True, **ACC_WEIGHTS)
    ds, _ = ab.datasets(root, info_path, cfg)
    _, b0 = next(ab.weak_batches(ds, ACC_BATCH))
    trainer = apis.init_trainer(cfg, ACC_STEPS, device=DEVICE, seed=0,
                                optimizer=dict(lr=ACC_LR, cyclic=False))
    logs0, rec, _ = recorded_step(torch, apis, sp, mods, trainer, b0)
    finite_logs(torch, {'loss': logs0['loss']}, 'accuracy recorded step')
    n_rec = {k: len(v) for k, v in rec.items()}
    want = {k: ACC_PER_STEP[k] for k in n_rec}
    if n_rec != want:
        fail(f'accuracy recorded step: kernel calls {n_rec}, expected {want}')
    torch.set_grad_enabled(False)
    conv_rows, dwr, _ = train_kernel_rows(
        torch, sparse_conv, rec, 'accuracy kernels', ACC_CONVS, ACC_DGRAD)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    gr_rows = rows_rows(torch, gr, [a for _, a in rec['gather_rows']], False,
                        'accuracy kernels', flush)
    hm_rows = heatmap_rows(torch, heatmap, rec['render_heatmap'],
                           'accuracy kernels')
    torch.set_grad_enabled(True)
    del flush, rec, trainer
    torch.cuda.empty_cache()

    # --- 3. the main path: the weak-train CLI -----------------------------
    dump = os.path.join(root, 'pseudo.pkl')
    state = os.path.join(root, 'state.pt')
    argv = ['--root', root, '--scenes', str(ACC_SCENES), '--steps',
            str(ACC_STEPS), '--batch', str(ACC_BATCH), '--eval-every',
            str(ACC_EVAL_EVERY), '--dump-pseudo', dump, '--save-state', state,
            '--device', DEVICE, *ACC_FLAGS]
    t0 = time.perf_counter()
    with per_call(apis, 'train_step', torch, mods) as steps, \
            per_call(apis, 'infer', torch, mods) as fwds:
        zero_counts(mods)
        out = ab.main(argv)
        got = counts(mods)
    cli_s = time.perf_counter() - t0
    if len(steps) != ACC_STEPS:
        fail(f'accuracy: the CLI took {len(steps)} steps, expected '
             f'{ACC_STEPS}')
    for i, c in enumerate(steps):
        if c['launches'] != ACC_PER_STEP:
            fail(f'accuracy: step {i + 1} launched {c["launches"]}, expected '
                 f'{ACC_PER_STEP}')
    fwd_want = dict.fromkeys(ACC_PER_STEP, 0)
    fwd_want['gather_gemm_conv'] = ACC_CONVS
    for i, c in enumerate(fwds):
        if c['launches'] != fwd_want:
            fail(f'accuracy: eval forward {i} launched {c["launches"]}, '
                 f'expected {fwd_want}')
    total = {k: ACC_STEPS * v + len(fwds) * fwd_want[k]
             for k, v in ACC_PER_STEP.items()}
    if got != total:
        fail(f'accuracy: the CLI launched {got}, expected {total}')
    losses = torch.stack([c['out']['loss'] for c in steps]).cpu()
    if not torch.isfinite(losses).all():
        bad = int((~torch.isfinite(losses)).nonzero()[0, 0]) + 1
        fail(f'accuracy: loss {float(losses[bad - 1])} at step {bad}')
    for key in ('untrained', 'trained'):
        if set(out[key]) != set(ab.AP_KEYS):
            fail(f'accuracy: {key} AP keys {sorted(out[key])}')
    step_ms = events_ms(torch, steps)
    fwd_ms = events_ms(torch, fwds)
    n_evals = len(out['eval_s'])
    scenes_evaluated = n_evals * ACC_SCENES
    res.update(
        stage1=stage1, untrained=out['untrained'], trained=out['trained'],
        curve=out['curve'], launches=got, steps=ACC_STEPS,
        losses=[float(v) for v in losses[::max(ACC_STEPS // 20, 1)]],
        last_loss=float(losses[-1]), step_ms=step_ms,
        scenes_per_s=ACC_STEPS * ACC_BATCH / (sum(step_ms) / 1e3),
        scenes_per_s_loader=ACC_STEPS * ACC_BATCH / out['train_s'],
        train_s=out['train_s'], forwards=len(fwds), forward_ms=fwd_ms,
        eval_scenes_per_s=scenes_evaluated / (sum(fwd_ms) / 1e3),
        eval_scenes_per_s_host=scenes_evaluated / sum(out['eval_s']),
        cli_s=cli_s, conv_calls=conv_rows, dw_calls=dwr,
        gather_rows=gr_rows, heatmap=hm_rows)
    print(f'{card}: accuracy weak training ({ACC_STEPS} steps x '
          f'{ACC_BATCH} scenes, small, f32): '
          f'{res["scenes_per_s"]:.2f} scenes/s by CUDA events around each '
          f'step (median {sorted(step_ms)[len(step_ms) // 2]:.2f} ms), '
          f'{res["scenes_per_s_loader"]:.2f} with the in-process loader; '
          f'launches {ACC_PER_STEP} at every step; loss '
          f'{res["losses"][0]:.4g} -> {res["last_loss"]:.4g}')
    print(f'{card}: accuracy evals: {len(fwds)} forwards of {ab.EVAL_BATCH} '
          f'scenes, {res["eval_scenes_per_s"]:.2f} scenes/s by CUDA events '
          'around apis.infer, '
          f'{res["eval_scenes_per_s_host"]:.2f} with loading, matching and '
          'kitti_eval (host)')
    print('accuracy AP: untrained ' + json.dumps(out['untrained'])
          + '; curve ' + json.dumps(out['curve']))

    # the saved weights, reloaded, evaluated twice
    bundle = apis.init_detector(cfg, torch.load(state, map_location=DEVICE),
                                device=DEVICE)
    _, ds_test = ab.datasets(root, info_path, cfg)
    again = [ab.evaluate_pseudo(bundle, ds_test, infos) for _ in range(2)]
    if again[0] != out['trained'] or again[1] != out['trained']:
        fail(f'accuracy: the reloaded state evaluates to {again}, the CLI '
             f'to {out["trained"]}')
    print('accuracy: the saved state, reloaded, evaluates twice to the '
          'CLI\'s trained AP')
    del bundle
    torch.cuda.empty_cache()

    # --- 4. stage 4 on the dump -------------------------------------------
    argv = ['--root', root, '--pseudo', dump, '--steps', str(ACC_S4_STEPS),
            '--batch', str(ACC_BATCH), '--eval-reps', str(ACC_S4_REPS),
            '--device', DEVICE]
    t0 = time.perf_counter()
    with per_call(apis, 'pgd_train_step', torch, mods) as s4_steps:
        zero_counts(mods)
        out4 = s4.main(argv)
        got = counts(mods)
    s4_s = time.perf_counter() - t0
    if any(got.values()):
        fail(f'accuracy stage 4: kernels launched {got}')
    if len(s4_steps) != ACC_S4_STEPS:
        fail(f'accuracy stage 4: {len(s4_steps)} steps, expected '
             f'{ACC_S4_STEPS}')
    s4_logs = [{k: float(c['out'][k]) for k in ('loss', 'num_pos')}
               for c in s4_steps]
    for i, lg in enumerate(s4_logs):
        if not (np.isfinite(lg['loss']) and lg['num_pos'] > 0):
            fail(f'accuracy stage 4: step {i + 1} logs {lg}')
    keys = set(s4.MONO_AP_KEYS)
    for r in (out4['untrained'], out4['trained'], *out4['eval_reps']):
        if set(r) != keys:
            fail(f'accuracy stage 4: AP keys {sorted(r)}')
    if any(r != out4['trained'] for r in out4['eval_reps']):
        fail(f'accuracy stage 4: the final evals differ: '
             f'{out4["eval_reps"]} vs {out4["trained"]}')
    s4_ms = events_ms(torch, s4_steps)
    res['stage4'] = dict(
        data_quality=out4['pseudo_data_quality'],
        untrained=out4['untrained'], trained=out4['trained'], logs=s4_logs,
        step_ms=s4_ms,
        images_per_s=(len(s4_ms) - 1) * ACC_BATCH / (sum(s4_ms[1:]) / 1e3),
        train_s=out4['train_s'], cli_s=s4_s)
    print(f'{card}: accuracy stage 4 (PGD tiny, B = {ACC_BATCH}, '
          f'{ACC_S4_STEPS} steps): {res["stage4"]["images_per_s"]:.2f} '
          'images/s by CUDA events after the first step; positives '
          f'{[int(lg["num_pos"]) for lg in s4_logs]}; pseudo-label quality '
          f'{json.dumps(out4["pseudo_data_quality"])}; AP trained '
          f'{json.dumps(out4["trained"])} ({ACC_S4_REPS} evals equal)')
    res['phase_s'] = time.perf_counter() - t_phase
    print(f'{card}: accuracy phase {res["phase_s"]:.1f} s (weak-train CLI '
          f'{cli_s:.1f} s, stage-4 CLI {s4_s:.1f} s)')
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


def train_kernel_rows(torch, sparse_conv, rec, label, n_convs=None,
                      n_dgrad=None):
    """The recorded step's gather_gemm_conv calls (forward, then the
    submanifold input gradients) and gather_gemm_dw calls, replayed
    against their plain versions and timed; ``n_convs`` and ``n_dgrad``
    (by default the GGA step's) are their expected counts."""
    n_convs = N_CONVS if n_convs is None else n_convs
    n_dgrad = N_DGRAD if n_dgrad is None else n_dgrad
    conv_calls = rec['gather_gemm_conv']
    fwd_calls = [a for ph, a in conv_calls if ph == 'forward']
    dgrad_calls = [a for ph, a in conv_calls if ph == 'backward']
    if (len(fwd_calls), len(dgrad_calls)) != (n_convs, n_dgrad):
        fail(f'{label}: {len(fwd_calls)} forward and {len(dgrad_calls)} '
             f'input-gradient convs, expected {n_convs} and {n_dgrad}')
    conv_rows = [conv_row(torch, sparse_conv, *a, f'{label} call {i}')
                 for i, a in enumerate(fwd_calls + dgrad_calls)]
    print_conv_rows(f'{label}: gather_gemm_conv vs plain at the step\'s '
                    f'{n_convs} forward calls', conv_rows[:n_convs])
    print_conv_rows(f'{label}: gather_gemm_conv vs plain at the step\'s '
                    f'{n_dgrad} submanifold input-gradient calls',
                    conv_rows[n_convs:])
    dwr = dw_rows(torch, sparse_conv, rec['gather_gemm_dw'], label)
    return conv_rows, dwr, fwd_calls


def print_step_comparison(label, cmp_step):
    print(f'{label}: loss {cmp_step["loss_kernel"]:.8g} vs '
          f'{cmp_step["loss_plain"]:.8g} (rel {cmp_step["loss_rel"]:.3g}),'
          f' grad norm {cmp_step["grad_norm_kernel"]:.8g} vs '
          f'{cmp_step["grad_norm_plain"]:.8g} (rel '
          f'{cmp_step["grad_norm_rel"]:.3g}; plain step, one ulp of input '
          f'noise: {cmp_step["grad_norm_rel_plain_ulp_noise"]:.3g}), min '
          f'cosine of the {cmp_step["conv_weight_grads"]} sparse conv weight '
          'gradients '
          f'{cmp_step["min_cosine"]:.8f} (plain step, one ulp of input '
          f'noise: {cmp_step["min_cosine_plain_ulp_noise"]:.8f}; plain step, '
          f'sums reordered: {cmp_step["min_cosine_plain_reordered"]:.8f}, '
          f'grad norm rel {cmp_step["grad_norm_rel_plain_reordered"]:.3g}); '
          'batch-norm '
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
        torch.cuda.empty_cache()
        # --- the supervised KITTI path: SECOND and PointPillars ---
        sup = supervised_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- the accuracy benches: weak training to AP, then stage 4 ---
        acc = accuracy_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- DVSECOND, bf16 SECOND, SASSD and DynamicVoxelNet ---
        vf = voxel_family_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- nuScenes CenterPoint: voxel, DCN circle NMS, pillar DCN ---
        cp = centerpoint_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- PartA2: SparseUNet, RPN and the part-aggregation RoI head ---
        pa = parta2_phase(torch, mods, card, tmp)

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
    # the anchor detectors' steps (f32): both sparse-conv kernels and
    # gather_rows
    for path, res in (('second', sup), ('dvsecond', vf['dvsecond']),
                      ('sassd', vf['sassd'])):
        for entry, key, rows, lib in (
                (kernels[2], 'gather_gemm_conv', res['conv_calls'], None),
                (kernels[3], 'gather_gemm_dw', res['dw_calls'], None),
                (kernels[4], 'gather_rows', res['gather_rows'],
                 sum(r['library_ms'] for r in res['gather_rows']))):
            e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                             entry['replaces'],
                             res['train']['launches'][key], rows,
                             library_ms=lib)
            entry[path] = {k: e[k] for k in (
                'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
                'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
                'ffma_bound_ms', 'library_ms')}
    # the accuracy bench's weak-train step (f32, small): conv, dW,
    # gather_rows and render_heatmap
    for entry, key, rows, lib in (
            (kernels[2], 'gather_gemm_conv', acc['conv_calls'], None),
            (kernels[3], 'gather_gemm_dw', acc['dw_calls'], None),
            (kernels[4], 'gather_rows', acc['gather_rows'],
             sum(r['library_ms'] for r in acc['gather_rows'])),
            (kernels[6], 'render_heatmap', acc['heatmap'], None)):
        e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                         entry['replaces'], acc['launches'][key], rows,
                         library_ms=lib)
        entry['accuracy'] = {k: e[k] for k in (
            'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
            'ffma_bound_ms', 'library_ms', 'host_ms')}
    # the CenterPoint 0.1 m voxel step (f32, B = 4): conv, dW,
    # gather_rows and render_heatmap
    cpm = cp['main']
    for entry, key, rows, lib in (
            (kernels[2], 'gather_gemm_conv', cpm['conv_calls'], None),
            (kernels[3], 'gather_gemm_dw', cpm['dw_calls'], None),
            (kernels[4], 'gather_rows', cpm['gather_rows'],
             sum(r['library_ms'] for r in cpm['gather_rows'])),
            (kernels[6], 'render_heatmap', cpm['heatmap'], None)):
        e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                         entry['replaces'], cpm['launches'][key], rows,
                         library_ms=lib)
        entry['centerpoint'] = {k: e[k] for k in (
            'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
            'ffma_bound_ms', 'library_ms', 'host_ms')}
    # PartA2's steps (f32, B = 2): the two sparse-conv kernels, the
    # inverse convs' swapped maps among their calls
    for entry, key, rows in (
            (kernels[2], 'gather_gemm_conv', pa['conv_calls']),
            (kernels[3], 'gather_gemm_dw', pa['dw_calls'])):
        e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                         entry['replaces'], pa['launches'][key], rows)
        entry['parta2'] = {k: e[k] for k in (
            'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
            'ffma_bound_ms', 'library_ms')}
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
        for path, steps in (('indoor', sum(r['steps']
                                           for r in ind['train'])),
                            ('second', sup['train']['steps']),
                            ('accuracy', acc['steps']),
                            ('centerpoint', cpm['steps']),
                            ('parta2', pa['steps']),
                            *((t, vf[t]['train']['steps'])
                              for t, _ in VF_PATHS)):
            if path not in k:
                continue
            d = k[path]
            print(f'  {"":20s} {path}: {d["launches"]:4d} launches in '
                  f'{steps} steps; one step: ms {d["ms"]:.4f}  device '
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
                       f32=f32, workflow=wf, stage4=s4, indoor=ind,
                       supervised=sup, accuracy=acc, voxel_family=vf,
                       centerpoint=cp, parta2=pa),
                  fh, indent=1, default=str)

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
