#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's stage-3 inference and GGA weak training
paths, the GGA workflow's command-line tools, the stage-4 PGD retrain,
the indoor FCAF3D retrain, the fully supervised SECOND and PointPillars,
the accuracy benches, the rest of the KITTI voxel detectors (DVSECOND,
SASSD, DynamicVoxelNet), the fully supervised nuScenes CenterPoint, the
two-stage PartA2, the indoor family (stage 1 for SUN RGB-D and ScanNet,
FCAF3D on ScanNet, VoteNet), the VoteNet-derived indoor detectors
(GroupFree3D, H3DNet, ImVoteNet), the point-cloud segmentors (PointNet++
SSG and MSG, DGCNN, PAConv), the image-fusion and image-to-voxel
detectors (MVXNet, ImVoxelNet), the sharded stage 3 and the two-rank
data-parallel GGA step, the point-based KITTI detectors (3DSSD,
PointRCNN), the nuScenes and Lyft pillar detectors and the monocular KITTI
detectors (SMOKE, MonoFlex) on one NVIDIA card.

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
   free workspace, so the two sides could run different dense plans),
   the later steps on the kernel step's ReLU masks and scatter-max
   winners (a unit that rounding moves to the other branch moves its
   whole gradient; the units overridden are printed): loss within 1e-2 relative, grad norm within 5e-2 relative,
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
17. Indoor family phase (``indoor_family_phase``, last). Stage 1 on the
    card machine: raw SUN RGB-D (24 scenes: ``.mat`` depth clouds of
    30 000 points, label and calib text, frame-header-only JPEGs) and
    ScanNet (12 scenes: 50 000 vertices, aligned boxes, NYU40 labels)
    layouts written from seed 0 and converted by
    ``gga_tpu_torch.tools.create_data.main``: the info count of each
    split, every points dump N x 6, the boxes and classes as written,
    the converters' seconds. FCAF3D as shipped on ScanNet
    (configs/fcaf3d/fcaf3d_8x2_scannet-3d-18class.py, f32, B = 2 x 40 000
    points from ``ScanNetDataset``): one whole step with kernels against
    plain on the initial weights (the f32 gates of 8., cuDNN off); 2
    recorded ``apis.fcaf3d_train_step`` calls and ``infer_indoor`` over
    the val split with exact launches (79 / 40 a step, 40 a forward),
    every call against plain, step 1's timed (the ScanNet kernel rows),
    each step's lr, finite losses, moved weights, active sites against
    every budget; ``indoor_eval``. VoteNet as shipped (PointNet2SASSG +
    VoteHead, f32, the height above the floor as the 4th channel, built
    in this script) on SUN RGB-D at B = 16 x 20 000 points (3 steps,
    ``infer_votenet`` over the val split, ``indoor_eval`` at 0.25 /
    0.5, a profile of one more step), on ScanNet at B = 8 x 40 000 (2
    steps and inference) and with the IoU loss (1 step): no kernel
    launched, every parameter and output on the card, finite losses
    with every term, each step's lr, moved weights, device ms a step by
    stage (FPS + ball query, SA MLPs, FP, vote head, targets + loss,
    backward, clip + AdamW), scenes/s, peak memory, and, not gated, one
    scene's forward on the card against the CPU's.
17b. Vote-derived phase (``vote_derived_phase``, on the indoor family's
    stage-1 data): GroupFree3D L6-O256 (B = 4 x 40 000, xyz), H3DNet
    (B = 3 x 40 000, four towers) and ImVoteNet (B = 16 x 20 000, seeded
    uint8 images at SUN RGB-D's size, the boxes' projections through the
    infos' calib plus seeded distractors as 2D boxes) as shipped, f32,
    seeded weights (``vote_derived_path``): the card's eval forward at
    B = 1 against the CPU's (every tower's level-0 FPS equal; with the
    CPU's picks given, every output within 1e-4 of max|CPU|; the share of
    the picks the card makes alone that equal the CPU's printed),
    VD_STEPS (1) recorded train steps (no kernel launch, finite losses,
    positives, the schedule's lr, moved weights; device ms by stage: FPS,
    ball query + grouping, backbone MLPs, heads, targets + loss,
    backward, clip + AdamW; the FPS share; peak memory) and one ``infer_*`` call (boxes
    [B, n, 7], finite); the widest GroupFree3D, w2x-L12-O512, the
    forward against the CPU's and one inference only.
17c. Segmentation phase (``segmentation_phase``, on the indoor family's
    mini ScanNet and a mini S3DIS written from seed 0 and converted by
    ``create_data s3dis``): PointNet++ SSG on ScanNet (B = 16 x 8 192, 6
    channels), PointNet++ MSG, DGCNN (k = 20) and PAConv (M = 8) on S3DIS
    (B = 8 / 32 / 8 x 4 096, 9 channels: xyz | rgb | xyz over the scene's
    per-axis maximum, built here) as shipped, f32, seeded weights
    (``segmentation_path``): the card's eval forward at B = 1 against the
    CPU's (every FPS level, and DGCNN's D-KNN graph, equal; with the
    CPU's picks given, the logits within 1e-4 of max|CPU|; the share of
    the picks the card makes alone that equal the CPU's printed), 2
    recorded ``apis.segmentor_train_step`` calls with the stage-1 label
    weights (no kernel launch, finite losses, the cyclic schedule's lr,
    moved weights; device ms by stage: FPS + ball query + grouping, kNN
    graph, MLPs / PAConv, head, loss, backward, clip + AdamW, each with
    its share; peak memory), ``infer_segmentor`` over the val split with
    ``seg_eval`` (miou, acc, acc_cls finite) and ``inference_segmentor``
    on one whole scene.
17d. Fusion phase (``fusion_phase``, on the workflow's mini KITTI and the
    indoor family's mini SUN RGB-D): MVXNet as shipped (B = 2 x up to
    24 000 points and the scenes' 375 x 1242 PNGs, f32, seeded weights;
    ``mvxnet_path``): the card's eval forward at B = 1 against the CPU's
    (1e-4 of max|CPU|), the whole step with kernels against plain (cuDNN
    off; the f32 gates), 2 recorded ``apis.mvxnet_train_step`` calls with
    exactly 20 gather_gemm_conv (conv_input's input gradient among them:
    the fused VFE below it carries weights), 12 gather_gemm_dw and 4
    gather_rows a step, finite losses, positives, the cyclic lr, moved
    weights, device ms by stage and peak memory, every recorded kernel
    call replayed against its plain version, a profile of one more step
    (cuDNN's FFT plan's share), ``infer_mvxnet`` and
    ``inference_multi_modality_detector``; both ImVoxelNet configs (KITTI
    car at B = 4, Car as label 0; SUN RGB-D at B = 2 on seeded 530 x 730
    images; ``imvoxelnet_path``): the card against the CPU, 2 steps with
    no launch of any wrapper, ``infer_imvoxelnet``.
18. Data-parallel phase (``data_parallel_phase``, last): two processes
    on the one card. (a) The stage-3 CLI as ``--rank 0/1 --world 2
    --tmpdir`` (spawned, started together) on the workflow's mini KITTI
    with the matching config as shipped, against the same CLI in one
    process: rank 0's merged pseudo pkl must hold the one-process pkl's
    scenes in its order with the same box count a scene, boxes and
    scores within 1e-4 (the largest difference of every float field is
    printed: the two runs batch other scenes together, so cuDNN may pick
    other algorithms); each rank launches 21 gather_gemm_conv per batch
    and nothing else. The checkpoint holds the seeded weights, as the
    workflow's six steps leave no box above the score threshold. (b) The
    full-width f32 GGA step (``configs('float32')``, bench.py's point) as
    two ``gloo`` ranks of 4 scenes (``parallel.mesh``; NCCL refuses two
    ranks on one device) against one process of 8, from the same seeded
    weights, batch and SRL draw, cuDNN off on both sides, the one-process
    step first and freed: the loss within 1e-4 relative, each sparse conv
    weight gradient (summed over the ranks, before the clip, in float64)
    at cosine >= 0.9999, or >= 0.999 within twice the one-process step's
    one-ulp distance, every batch-norm running statistic within 1e-4
    relative plus 1e-5; then ``DP_STEPS`` train steps a rank with exact
    launches (37 / 21 / 4 / 1 a step on each rank) and the weights
    bit-equal on both ranks after them. Prints per-rank step ms, the
    gradients' all-reduce ms and peak memory a rank. Gloo on one card
    says nothing of NCCL across cards.
19. Point family phase (``point_family_phase``, last): 3DSSD's car config
    (B = 4) and PointRCNN's 3-class config (B = 2) as shipped, f32, at
    16 384 points a scene of the workflow's mini KITTI, seeded weights
    (``point_path``): the card's eval forward against the same forward
    on the CPU (level-0 D-FPS indices equal; with the CPU's sampled
    indices and, for PointRCNN, its proposals given, every output within
    1e-4 of max|CPU|; the share of the picks the card makes alone that
    equal the CPU's printed), PF_STEPS (1) recorded train steps (no launch,
    finite losses, positives, the schedule's lr, moved weights; device
    ms by stage: D-FPS, F-FPS, ball query + grouping, SA MLPs, head or
    FP neck, RPN + NMS and RoI stage; peak memory) and one
    ``infer_ssd3d`` / ``infer_point_rcnn`` call (boxes [B, n, 7], finite,
    3DSSD's dims at least 0.1).
19a. Pillar family phase (``pillar_family_phase``, last): FreeAnchor,
    SSN, the RegNet backbones and PointPillars' FPN neck and bf16, on the
    CenterPoint phase's mini nuScenes and a mini Lyft of Lyft's nine
    classes written here, seeded weights (``pillar_path``): FreeAnchor
    with RegNet-1.6GF and the FPN neck (B = 4, 3 steps) and SSN SECFPN
    (B = 2, 3 steps) on nuScenes, SSN RegNet-400MF on Lyft (800 x 800,
    B = 1, 2 steps), at lr 1e-3 (the shipped 0.008 diverges from seeded
    weights): the card's eval forward at B = 1 against the CPU's within
    1e-4 of max|CPU| and the loss of a train-mode forward at B = 1 (cuDNN
    off) within 1e-4 relative, recorded train steps (no kernel launch,
    finite losses, the cyclic lr, moved weights; device ms by stage, peak
    memory, positives printed), ``calibrate_bn``, ``infer_anchor`` /
    ``infer_ssn`` over the val key frames, then ``format_results`` and
    ``nuscenes_eval`` (mAP, NDS finite) or ``lyft_eval`` (mAP finite);
    the bf16 RegNet-400MF FPN config (``pillar_bf16``): refused by the
    builder and ``init_anchor_detector``, its detector built directly
    takes the whole bf16 step on the card (cuDNN off) against the CPU's at
    B = 1, measured against the bf16 gates (loss 1e-2, grad norm 5e-2,
    each gradient's cosine >= 0.99, or within twice the card's own
    one-ulp noise and >= 0.97; BN updates 1e-2) and printed; then each of
    the 23 configs built on the card and run once at B = 1 after
    ``calibrate_bn`` (finite maps, no launch, peak memory), the three
    _fp16_ ones refused by the builder.
19b. Mono family phase (``mono_family_phase``, last): SMOKE (B = 8) and
    MonoFlex (B = 4) as shipped (f32, DLA-34 + DLANeck, seeded weights) on
    the workflow's mini KITTI images through ``KittiMonoDataset`` at 384 x
    1248 (``mono_path``): the card's eval forward of the first batch
    against the CPU's within 1e-4 of max|CPU|; 2 recorded train steps with
    each config's optimizer block (SMOKE: exactly one render_heatmap
    launch a step, its B x 3 heatmap targets of 96 x 312; MonoFlex: no
    launch), finite losses with positives, the lr, moved weights but the
    DLA trees' discarded projections; device ms by stage after the first
    step, peak memory; the recorded render_heatmap calls replayed against
    the plain renderer (1e-6); ``infer_smoke`` / ``infer_monoflex`` on a
    batch and ``inference_mono_3d_detector`` on one image (no launch).
20. Prints one JSON line describing the kernels (each with its time
    ms, device_ms, launches, bound and bound_share = bound_ms / ms,
    device_bound_share = bound_ms / device_ms, host_ms where measured;
    the f32 entries as gather_gemm_conv_f32 and gather_gemm_dw_f32, with
    ffma_bound_ms, their bound at the FFMA rate of 67 TFLOP/s, an
    ``indoor`` dict with the same numbers over FCAF3D's recorded step,
    ``second``, ``dvsecond`` and ``sassd`` dicts over those detectors'
    steps, which gather_rows carries too, and ``accuracy`` and
    ``centerpoint`` dicts over the accuracy bench's and the 0.1 m
    CenterPoint config's steps on the two f32 sparse-conv entries,
    gather_rows and render_heatmap, ``parta2`` dicts over PartA2's
    steps and ``scannet`` dicts over FCAF3D's ScanNet steps on the two
    f32 sparse-conv entries, and ``point_family``, ``vote_derived``,
    ``segmentation`` and ``pillar_family`` dicts with each kernel's
    launches in those phases, 0, and ``mono_family``: render_heatmap's
    SMOKE launches with its replayed calls' numbers, every other kernel's
    0),
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
import types
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
    """``fn()`` under torch.profiler: device busy share of the window, the
    kernels with the most device time (one stream, so kernel times do not
    overlap) and the time of cuDNN's FFT conv plans (the kernels named as
    FFTs and the complex f32 GEMMs, ``cf32``, between them)."""
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
                fft_ms=sum(e.self_device_time_total for e in ops
                           if 'fft' in e.key.lower() or 'cf32' in e.key)
                / 1e3,
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


def loss_and_grads(torch, trainer, batch, loss_fn, conv_types=None,
                   after_backward=None):
    """One step's loss (``loss_fn(model, batch)`` of a train-mode
    forward), gradient norm, sparse conv weight gradients (of the modules
    of ``conv_types``, by default the submanifold and compact strided
    convs; a module's ``weight``, else its ``kernel``) and batch-norm
    statistics updates, without the optimizer; the running statistics
    are restored afterwards. ``after_backward`` runs between the backward
    and the reading of the gradients (a data-parallel rank's all-reduce)."""
    from gga_tpu_torch.models.layers import SubMConv3d, SparseConv3d
    conv_types = conv_types or (SubMConv3d, SparseConv3d)
    model = trainer.model
    model.train()
    model.zero_grad(set_to_none=True)
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    total = loss_fn(model, batch)
    total.backward()
    if after_backward is not None:
        after_backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    norm = float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    conv_grads = {n: getattr(m, 'weight', getattr(m, 'kernel', None))
                  .grad.detach().clone()
                  for n, m in model.named_modules()
                  if isinstance(m, conv_types)}
    stat_moves = {}
    with torch.no_grad():
        for n, b in model.named_buffers():
            stat_moves[n] = b - stats0[n]
            b.copy_(stats0[n])
    return float(total.detach()), norm, conv_grads, stat_moves


def ulp_bump(torch, x):
    """``x`` moved up by one ulp of its dtype in a seeded half of its
    nonzero entries."""
    g = torch.Generator(device=x.device).manual_seed(0)
    bump = (torch.rand(x.shape, generator=g, device=x.device)
            < 0.5) & (x != 0)
    bits = x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    return (bits + bump.to(bits.dtype)).view(x.dtype)


@contextlib.contextmanager
def input_ulp_noise(torch, model, module=None):
    """The first input of ``module`` (by default the sparse encoder, whose
    input is the VFE output) moved up by one ulp of its dtype in a seeded
    half of its nonzero entries: a perturbation as small as one rounding
    step, to measure how far the step's gradients move under rounding
    alone."""
    enc = module or (getattr(model, 'pts_middle_encoder', None)
                     or model.middle_encoder)
    real = enc.forward

    def noisy(feats, *args, **kwargs):
        return real(ulp_bump(torch, feats), *args, **kwargs)

    enc.forward = noisy
    try:
        yield
    finally:
        enc.forward = real


@contextlib.contextmanager
def frozen_branches(torch):
    """The two value-chosen branches of the steps' forwards frozen for the
    steps of one comparison: ``torch.nn.functional.relu`` (and so every
    ``nn.ReLU``) and ``Tensor.scatter_reduce(_)(..., 'amax')`` of a float
    source that takes a gradient (PartA2's RoI max pooling, the dynamic
    VFE's voxel max). The first step run under it records, call by call,
    each ReLU's mask (input > 0) and each scatter max's winners (the
    sources equal to their slot's max); each later step, begun with
    ``replay()``, passes a ReLU's input where the first step's mask is
    set and lets only the first step's winners into a slot's max (ties
    among them still split the gradient). A rounding that moves one
    pre-activation across 0, or one source past its slot's max, moves
    that unit's whole gradient, and where the loss's gradient sits on few
    units (random weights, few positive anchors) that alone can part a
    weight gradient by 1e-4 of cosine. With the branches frozen every step
    takes the first step's, so what parts them is the arithmetic.
    ``flips()`` counts, for each replayed step, the units whose own value
    would have taken the other branch; ``units()`` the units frozen."""
    F = torch.nn.functional
    T = torch.Tensor
    real_relu, real_scatter, real_scatter_ = (F.relu, T.scatter_reduce,
                                              T.scatter_reduce_)
    frozen, flips = [], []
    state = dict(i=None)

    def take(kind, shape):
        i = state['i']
        if (i >= len(frozen) or frozen[i][0] != kind
                or frozen[i][1].shape != shape):
            fail(f'step comparison: a replayed step\'s call {i} ({kind}) is '
                 'not the first step\'s')
        state['i'] = i + 1
        return frozen[i][1]

    def relu(x, inplace=False):
        if state['i'] is None:
            frozen.append(('relu', (x > 0).detach()))
            return real_relu(x, inplace=inplace)
        m = take('relu', x.shape)
        flips[-1] = flips[-1] + ((x > 0) != m).sum()
        return x.masked_fill_(~m, 0) if inplace else x.masked_fill(~m, 0)

    def scatter_max(inplace):
        real = real_scatter_ if inplace else real_scatter

        def reduce_(self, dim, index, src, reduce, **kwargs):
            if reduce != 'amax' or not (src.is_floating_point()
                                        and src.requires_grad):
                return real(self, dim, index, src, reduce, **kwargs)
            if state['i'] is None:
                out = real(self, dim, index, src, reduce, **kwargs)
                frozen.append(('amax',
                               (src == out.gather(dim, index)).detach()))
                return out
            w = take('amax', src.shape)
            own = real_scatter(self, dim, index, src, reduce, **kwargs)
            flips[-1] = flips[-1] + (
                (src == own.gather(dim, index)) != w).sum()
            return real(self, dim, index, src.masked_fill(~w, -torch.inf),
                        reduce, **kwargs)
        return reduce_

    def check():
        if state['i'] not in (None, len(frozen)):
            fail(f'step comparison: a replayed step made {state["i"]} '
                 f'branch calls, the first {len(frozen)}')

    def replay():
        check()
        state['i'] = 0
        flips.append(0)

    F.relu, T.scatter_reduce, T.scatter_reduce_ = (
        relu, scatter_max(False), scatter_max(True))
    try:
        yield types.SimpleNamespace(
            replay=replay, flips=lambda: [int(f) for f in flips],
            units=lambda: sum(m.numel() for _, m in frozen))
        check()
    finally:
        F.relu, T.scatter_reduce, T.scatter_reduce_ = (
            real_relu, real_scatter, real_scatter_)


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
                    n_convs=None, conv_types=None, gated=True,
                    noise_module=None):
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
    the gate where the kernels do not. Every step after the kernel step
    takes the kernel step's ReLU masks and scatter-max winners
    (``frozen_branches``): a unit that rounding moves to the other branch
    would otherwise jump a gradient past the gate (PartA2's conv_out by
    1e-4 of cosine, on the plain step with one ulp of noise as with the
    kernels). The units each step's own values would have moved are
    reported beside."""
    # CenterPoint's config has no dtype: it runs in f32
    gate = GATES[getattr(trainer.model.cfg, 'compute_dtype', 'float32')]
    n_convs = N_CONVS if n_convs is None else n_convs
    if loss_fn is None:
        srl = torch.randn((3, B), generator=torch.Generator().manual_seed(
            5)).to(batch['labels'].device)

        def loss_fn(model, b):
            return gga_loss(model, b, srl)
    with torch.backends.cudnn.flags(enabled=False), \
            frozen_branches(torch) as branches:
        loss_k, norm_k, g_k, bn_k = loss_and_grads(torch, trainer, batch,
                                                   loss_fn, conv_types)
        with plain_versions(wrappers(mods)):
            branches.replay()
            loss_p, norm_p, g_p, bn_p = loss_and_grads(torch, trainer, batch,
                                                       loss_fn, conv_types)
            branches.replay()
            with input_ulp_noise(torch, trainer.model, noise_module):
                _, norm_n, g_n, _ = loss_and_grads(torch, trainer, batch,
                                                   loss_fn, conv_types)
        branches.replay()
        with plain_reordered(torch, mods):
            _, norm_r, g_r, _ = loss_and_grads(torch, trainer, batch, loss_fn,
                                               conv_types)
    flips, units = branches.flips(), branches.units()

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
               relu_units=units, relu_flips_plain=flips[0],
               relu_flips_plain_ulp_noise=flips[1],
               relu_flips_plain_reordered=flips[2],
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


def forward_flop(torch, detector):
    """FLOPs of ``detector``'s forward (a model of the port, built on the
    meta device) on one 384 x 1248 image, counted by
    ``torch.utils.flop_counter`` (shapes only)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device('meta'):
        x = torch.empty(1, 3, 384, 1248)
    with FlopCounterMode(display=False) as counter:
        detector(x)
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
    from gga_tpu_torch.models.detectors.pgd import PGDDetector
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
    with torch.device('meta'):
        detector = PGDDetector(model_cfg)
    res['forward_flop'] = forward_flop(torch, detector)
    del detector
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


def mini_indoor_scene(rng, n_points, floor_z=-1.2, class_dims=IN_CLASS_DIMS,
                      rotate=True):
    """One SUN RGB-D-like room in the depth frame (z up): a floor, two
    walls and 4-8 upright boxes of the classes of ``class_dims`` (their
    (dx, dy, dz)) inside +-6 m x +-2.5 m, turned about z where
    ``rotate`` (else axis-aligned, a zero yaw), points spread over the
    visible surfaces with a colour per surface: the background's first,
    then each box's, as many a box.
    Returns (points [n, 6] f32 xyzrgb, boxes [m, 7] gravity-centered
    (x, y, z, dx, dy, dz, yaw), labels [m])."""
    n_obj = rng.randint(4, 9)
    labels = rng.randint(0, len(class_dims), n_obj)
    dims = np.asarray(class_dims)[labels] * rng.uniform(0.85, 1.15,
                                                        (n_obj, 3))
    xy = np.stack([rng.uniform(-5.0, 5.0, n_obj),
                   rng.uniform(-1.8, 1.8, n_obj)], -1)
    yaw = rng.uniform(-np.pi, np.pi, n_obj)
    if not rotate:
        yaw = np.zeros(n_obj)
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


def mini_nuscenes_boxes(rng, classes=CP_CLASSES):
    """20-40 boxes of the ``classes`` (name: (dims, top speed)) around the
    ego (gravity-centre lidar boxes [N, 7], names, velocities [N, 2])."""
    names = list(classes)
    boxes, labels, vels = [], [], []
    for _ in range(rng.randint(20, 41)):
        for _ in range(50):       # a free spot
            name = names[rng.randint(len(names))]
            (dx, dy, dz), top = classes[name]
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


def write_mini_nuscenes(root, splits, n_sweeps=CP_SWEEPS, seed=0,
                        classes=CP_CLASSES, name='nuscenes'):
    """A mini nuScenes under ``root`` in the format the info pkls of
    mmdet3d's converter give: per key frame a lidar .bin (x, y, z,
    intensity, ring as float32, nuScenes' five columns) and
    ``n_sweeps`` past sweeps 0.05 s apart, taken from the moving ego
    (8 m/s, turning 0.05 rad/s) with their sensor-to-lidar transforms,
    of objects that moved with their velocities; 20-40 boxes of the
    ``classes`` (the ten nuScenes ones; Lyft's nine with ``name='lyft'``,
    whose infos keep the same format) with velocities, lidar point counts
    and the lidar2ego / ego2global transforms; ``{name}_infos_train.pkl``
    and ``{name}_infos_val.pkl``. Returns the points of a key frame's
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
            boxes, names, vels = mini_nuscenes_boxes(rng, classes)
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
        with open(os.path.join(root, f'{name}_infos_{split}.pkl'),
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
# (ROADMAP.md §3, PartA2), and these two meet such a jump unless the
# branches are frozen (``frozen_branches``)
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


# --- the indoor family: stage 1 for SUN RGB-D and ScanNet, FCAF3D on
#     ScanNet, VoteNet on SUN RGB-D and ScanNet ---------------------------
IF_SUN_SPLITS = (16, 8)     # train, val scenes of the raw mini SUN RGB-D
IF_SUN_POINTS = 30000       # depth points a scene
IF_SUN_IMAGE = (530, 730)   # (height, width) in each JPEG's frame header
IF_SN_SPLITS = (8, 4)       # train, val scenes of the raw mini ScanNet
IF_SN_POINTS = 50000        # vertices a scene
IF_WORKERS = 8              # create_data's --workers
IF_FCAF3D = 'configs/fcaf3d/fcaf3d_8x2_scannet-3d-18class.py'
IF_FCAF3D_STEPS = 2
# VoteNet's configs: (config, dataset, train steps, inference on the val
# split)
IF_VOTENET = (
    ('configs/votenet/votenet_16x8_sunrgbd-3d-10class.py', 'sunrgbd', 3,
     True),
    ('configs/votenet/votenet_8x8_scannet-3d-18class.py', 'scannet', 2,
     True),
    ('configs/votenet/votenet_iouloss_8x8_scannet-3d-18class.py', 'scannet',
     1, False))
# the 18 ScanNet classes' (dx, dy, dz), metres: the VoteNet ScanNet
# config's mean sizes
SN_CLASS_DIMS = (
    (0.77, 0.81, 0.93), (1.88, 1.84, 1.19), (0.61, 0.61, 0.72),
    (1.40, 1.51, 0.83), (0.98, 1.07, 0.63), (0.53, 0.60, 1.75),
    (0.96, 0.72, 1.15), (0.83, 1.05, 1.69), (0.21, 0.42, 0.54),
    (1.44, 1.90, 0.27), (1.03, 1.40, 0.88), (1.38, 0.66, 1.68),
    (0.67, 0.71, 1.30), (0.42, 0.38, 1.75), (0.59, 0.59, 0.74),
    (0.51, 0.51, 0.30), (1.15, 1.05, 0.50), (0.48, 0.49, 0.58))
# the loss terms of every VoteNet step (plus iou_loss where its weight is
# set)
VN_TERMS = ('vote_loss', 'objectness_loss', 'center_loss', 'dir_class_loss',
            'dir_res_loss', 'size_class_loss', 'size_res_loss',
            'semantic_loss', 'loss', 'num_pos', 'grad_norm')
VN_STAGES = ('FPS + ball query', 'SA MLPs', 'FP', 'vote head',
             'targets + loss', 'backward', 'clip + AdamW')


def jpeg_header(height, width):
    """A baseline JPEG's SOI, its SOF0 frame header (``height`` x
    ``width``, three components) and EOI, with no scan: the machine with
    the card has no image library, and the converter reads the shape
    from the frame header alone."""
    import struct
    comps = b''.join(bytes((i, 0x11, 0)) for i in (1, 2, 3))
    return (b'\xff\xd8\xff\xc0' + struct.pack('>HBHHB', 17, 8, height, width,
                                              3) + comps + b'\xff\xd9')


def write_raw_sunrgbd(root, splits=IF_SUN_SPLITS, n_points=IF_SUN_POINTS,
                      seed=0):
    """SUN RGB-D's raw layout under ``root`` (``sunrgbd_trainval/{depth/
    *.mat, label/*.txt, calib/*.txt, image/*.jpg, train_data_idx.txt,
    val_data_idx.txt}``) of ``mini_indoor_scene`` rooms, ids from 1; each
    label file also holds a box of a class outside the ten. Returns
    {id: (boxes [m, 7] gravity-centred, labels [m])} as written."""
    import math
    import os

    from scipy import io as sio

    from gga_tpu_torch.data.sunrgbd import CLASSES
    rng = np.random.RandomState(seed)
    tv = os.path.join(root, 'sunrgbd_trainval')
    for d in ('depth', 'label', 'calib', 'image'):
        os.makedirs(os.path.join(tv, d), exist_ok=True)
    k = np.array([[529.5, 0, 365.0], [0, 529.5, 265.0], [0, 0, 1]])
    written = {}
    ids = list(range(1, sum(splits) + 1))
    for idx in ids:
        pts, boxes, labels = mini_indoor_scene(rng, n_points)
        sio.savemat(os.path.join(tv, 'depth', f'{idx:06d}.mat'),
                    {'instance': pts})
        with open(os.path.join(tv, 'label', f'{idx:06d}.txt'), 'w') as f:
            # name xmin ymin dx dy (the 2-D box), cx cy cz, the half
            # sizes along y, x and z, then the heading's (cos, sin)
            for name, b in [*zip((CLASSES[i] for i in labels), boxes),
                            ('lamp', boxes[0])]:
                x, y, z, dx, dy, dz, yaw = (float(v) for v in b)
                f.write(f'{name} 10 20 100 80 {x!r} {y!r} {z!r} '
                        f'{dy / 2!r} {dx / 2!r} {dz / 2!r} '
                        f'{math.cos(yaw)!r} {math.sin(yaw)!r}\n')
        with open(os.path.join(tv, 'calib', f'{idx:06d}.txt'), 'w') as f:
            for m in (np.eye(3), k):
                f.write(' '.join(repr(float(v)) for v in
                                 m.reshape(-1, order='F')) + '\n')
        with open(os.path.join(tv, 'image', f'{idx:06d}.jpg'), 'wb') as f:
            f.write(jpeg_header(*IF_SUN_IMAGE))
        written[idx] = (boxes, labels)
    for split, part in (('train', ids[:splits[0]]),
                        ('val', ids[splits[0]:])):
        with open(os.path.join(tv, f'{split}_data_idx.txt'), 'w') as f:
            f.write('\n'.join(map(str, part)) + '\n')
    return written


def write_raw_scannet(root, splits=IF_SN_SPLITS, n_points=IF_SN_POINTS,
                      seed=0):
    """ScanNet's raw layout under ``root`` (``meta_data/scannetv2_{train,
    val}.txt`` + ``scannet_instance_data/{id}_{vert, aligned_bbox,
    unaligned_bbox, axis_align_matrix, sem_label, ins_label}.npy``) of
    axis-aligned ``mini_indoor_scene`` rooms of the 18 classes, their
    floor at z = 0 (ScanNet's aligned frame): each box's points carry its
    NYU40 id and instance, the floor and walls id 2 and instance 0.
    Returns {scene: (boxes [m, 7] gravity-centred with a zero yaw,
    labels [m])} as written."""
    import os

    from gga_tpu_torch.data.indoor_converter import SCANNET_DET_IDS
    rng = np.random.RandomState(seed)
    inst = os.path.join(root, 'scannet_instance_data')
    os.makedirs(inst, exist_ok=True)
    os.makedirs(os.path.join(root, 'meta_data'), exist_ok=True)
    names = [f'scene{i:04d}_00' for i in range(sum(splits))]
    written = {}
    for name in names:
        pts, boxes, labels = mini_indoor_scene(
            rng, n_points, floor_z=0.0, class_dims=SN_CLASS_DIMS,
            rotate=False)
        m = len(boxes)
        n_box = n_points * 2 // 5 // m
        n_bg = n_points - n_box * m
        ins = np.concatenate([np.zeros(n_bg, np.int64),
                              np.repeat(np.arange(1, m + 1), n_box)])
        sem = np.concatenate([np.full(n_bg, 2, np.int64),
                              np.repeat(SCANNET_DET_IDS[labels], n_box)])
        aligned = np.concatenate([boxes[:, :6].astype(np.float64),
                                  SCANNET_DET_IDS[labels][:, None]], -1)
        for suffix, arr in (('vert', pts), ('aligned_bbox', aligned),
                            ('unaligned_bbox', aligned),
                            ('axis_align_matrix', np.eye(4)),
                            ('sem_label', sem), ('ins_label', ins)):
            np.save(os.path.join(inst, f'{name}_{suffix}.npy'), arr)
        written[name] = (boxes, labels)
    for split, part in (('train', names[:splits[0]]),
                        ('val', names[splits[0]:])):
        with open(os.path.join(root, 'meta_data', f'scannetv2_{split}.txt'),
                  'w') as f:
            f.write('\n'.join(part) + '\n')
    return written


def check_infos(root, pkls, splits, written, n_points, label, atol):
    """The stage-1 gates: the info count of each split, every pts_path an
    N x 6 f32 dump of the scene's points, and the annos' boxes (within
    ``atol``) and classes those written. Returns the infos by split."""
    import os
    import pickle
    infos = {}
    for split, n in zip(('train', 'val'), splits):
        with open(pkls[split], 'rb') as f:
            infos[split] = pickle.load(f)
        if len(infos[split]) != n:
            fail(f'{label}: {len(infos[split])} {split} infos, expected {n}')
        for info in infos[split]:
            key = info['point_cloud']['lidar_idx']
            path = os.path.join(root, info['pts_path'])
            size = os.path.getsize(path) if os.path.exists(path) else None
            if size != n_points * 6 * 4:
                fail(f'{label}: {info["pts_path"]} holds {size} bytes, '
                     f'expected {n_points} x 6 f32')
            boxes, labels = written[key]
            a = info['annos']
            got = np.asarray(a.get('gt_boxes_upright_depth', np.zeros((0, 7))))
            if (a['gt_num'] != len(labels)
                    or not np.array_equal(a['class'], labels)
                    or not np.allclose(got, boxes[:, :got.shape[1]],
                                       rtol=0, atol=atol)):
                fail(f'{label}: scene {key}: annos {a["gt_num"]} boxes of '
                     f'classes {a.get("class")} differ from the '
                     f'{len(labels)} written ({labels})')
    return infos


def indoor_stage1(torch, card, tmp):
    """Stage 1 on the card machine: raw mini SUN RGB-D and ScanNet layouts
    written from seed 0, converted by ``create_data.main``, gated by
    ``check_infos``. Returns (dict of roots and pkls, the numbers)."""
    import os

    from gga_tpu_torch.data.indoor_converter import jpeg_shape
    from gga_tpu_torch.tools import create_data
    res, data = {}, {}
    for name, writer, splits, n_points, atol in (
            ('sunrgbd', write_raw_sunrgbd, IF_SUN_SPLITS, IF_SUN_POINTS,
             1e-5),
            ('scannet', write_raw_scannet, IF_SN_SPLITS, IF_SN_POINTS, 0.0)):
        root = os.path.join(tmp, f'{name}_raw')
        t0 = time.perf_counter()
        written = writer(root, splits, n_points)
        t1 = time.perf_counter()
        pkls = create_data.main([name, '--root-path', root, '--out-dir',
                                 root, '--workers', str(IF_WORKERS)])
        t2 = time.perf_counter()
        infos = check_infos(root, pkls, splits, written, n_points,
                            f'stage 1 {name}', atol)
        if name == 'sunrgbd':
            shapes = {tuple(i['image']['image_shape'])
                      for s in infos.values() for i in s}
            if shapes != {IF_SUN_IMAGE} or jpeg_shape(os.path.join(
                    root, 'sunrgbd_trainval', 'image',
                    '000001.jpg')) != IF_SUN_IMAGE:
                fail(f'stage 1 sunrgbd: image shapes {shapes}')
        else:
            for split in ('train', 'val'):
                for f in ('resampled_scene_idxs', 'label_weight'):
                    if not os.path.exists(os.path.join(
                            root, 'seg_info', f'{split}_{f}.npy')):
                        fail(f'stage 1 scannet: no seg_info {split}_{f}')
        res[name] = dict(write_s=t1 - t0, convert_s=t2 - t1,
                         infos={k: len(v) for k, v in infos.items()},
                         boxes=sum(len(w[1]) for w in written.values()))
        data[name] = dict(root=root, pkls=pkls)
        print(f'{card}: stage 1 {name}: raw layout of '
              f'{sum(splits)} scenes x {n_points} points written in '
              f'{t1 - t0:.2f} s, create_data {name} --workers {IF_WORKERS} '
              f'in {t2 - t1:.3f} s (host); infos {res[name]["infos"]}, '
              f'{res[name]["boxes"]} boxes and their classes as written, '
              'every points dump N x 6')
    return data, res


def fcaf3d_loss_fn(model, batch):
    """FCAF3D's loss of one forward in the model's mode."""
    from gga_tpu_torch.models.dense_heads import fcaf3d_head
    outs = model(batch['points'], batch['colors'], batch['points_valid'])
    return fcaf3d_head.loss(model.cfg.head, outs, batch['gt_boxes'],
                            batch['gt_labels'], batch['obj_valid'])[0]


def fcaf3d_scannet(torch, mods, card, data):
    """FCAF3D as shipped on ScanNet (configs/fcaf3d/fcaf3d_8x2_scannet-3d-
    18class.py: MinkResNet34 + head, 18 classes, axis-aligned boxes, f32,
    B = 2 x 40 000 points from ``ScanNetDataset`` on stage 1's infos):

    0. one whole step with kernels against plain on the seeded initial
       weights and the first batch, cuDNN off (``step_comparison``, the
       f32 gates, the noise at the backbone's input);
    1. main path: IF_FCAF3D_STEPS calls of ``apis.fcaf3d_train_step``,
       each recorded, then ``infer_indoor`` over the val split; the counts
       set to 0 just before and read just after: exactly 79
       gather_gemm_conv (40 forward, 39 input gradients) and 40
       gather_gemm_dw a step, 40 gather_gemm_conv a forward, nothing
       else; finite losses, each step's lr, every parameter and BN
       statistic moved, active sites against every budget;
    2. every recorded call against its plain version (``check_calls``),
       step 1's timed beside their bounds (the kernel rows' ScanNet
       entries);
    3. ``indoor_eval`` of the val split's detections (the mAP keys).
    Returns the numbers and the kernel rows."""
    from gga_tpu_torch import apis
    from gga_tpu_torch.apis import _INDOOR_DTYPES
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.scannet import CLASSES, ScanNetDataset
    from gga_tpu_torch.eval.indoor_eval import indoor_eval
    from gga_tpu_torch.models.backbones.mink_resnet import MinkConv
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    sparse_conv = mods[0]
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / IF_FCAF3D))
    model_cfg = build_detector(cfg)[1]
    head = model_cfg.head
    batch, n_points = cfg.data.samples_per_gpu, cfg.data.num_points
    root, pkls = data['root'], data['pkls']
    train_set = ScanNetDataset(root, pkls['train'], num_points=n_points,
                               max_objs=head.max_objs)
    batches = list(train_set.epoch_batches(batch, seed=0))
    trainer = apis.init_fcaf3d_trainer(model_cfg, len(batches),
                                       device=DEVICE, seed=0,
                                       optimizer=dict(cfg.optimizer))
    model = trainer.model
    print(f'fcaf3d scannet: {IF_FCAF3D}, MinkResNet{model_cfg.depth}, '
          f'{head.n_classes} classes, with_yaw {head.with_yaw}, voxel '
          f'{model_cfg.voxel_size} m, B = {batch} x {n_points} points, f32')
    res = {}

    # --- 0. the whole step against plain on the initial weights ----------
    n_mink = sum(isinstance(m, MinkConv) for m in model.modules())
    first = {k: torch.as_tensor(batches[0][k], dtype=dt, device=DEVICE)
             for k, dt in _INDOOR_DTYPES.items()}
    cmp_step = step_comparison(torch, mods, trainer, first, fcaf3d_loss_fn,
                               n_convs=n_mink, conv_types=(MinkConv,),
                               noise_module=model.backbone)
    print_step_comparison('fcaf3d scannet: whole step kernels vs plain '
                          '(initial weights, first batch, cuDNN off)',
                          cmp_step)
    res['step_comparison'] = cmp_step

    # --- 1. main path: the train steps, then inference over val ----------
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()
              if n.endswith(('running_mean', 'running_var'))}
    recs, logs, step_ms, diags, lrs = [], [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    for i in range(IF_FCAF3D_STEPS):
        diag = {}
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with recording(sparse_conv, 'gather_gemm_conv') as cc, \
                recording(sparse_conv, 'gather_gemm_dw') as dc:
            ev[0].record()
            logs.append(apis.fcaf3d_train_step(
                trainer, batches[i % len(batches)], diag))
            ev[1].record()
        lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
        recs.append(dict(gather_gemm_conv=cc, gather_gemm_dw=dc,
                         gather_rows=[], render_heatmap=[]))
        step_ms.append(ev)
        diags.append(diag)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    train_launches = counts(mods)
    val_set = ScanNetDataset(root, pkls['val'], num_points=n_points,
                             max_objs=head.max_objs, test_mode=True)
    gts, dts = [], []
    t_inf = time.perf_counter()
    for bt in val_set.epoch_batches(batch, shuffle=False, drop_last=False):
        d = apis.infer_indoor(apis.DetectorBundle(model, model_cfg,
                                                  torch.device(DEVICE)),
                              bt['points'], bt['colors'], bt['points_valid'])
        if not all(v.device.type == DEVICE for v in d.values()):
            fail('fcaf3d scannet: infer_indoor gave tensors off the card')
        d = {k: v.cpu().numpy() for k, v in d.items()}
        for j in range(len(bt['points'])):
            v = d['valid'][j]
            dts.append(dict(boxes=d['boxes'][j][v], labels=d['labels'][j][v],
                            scores=d['scores'][j][v]))
            ov = bt['obj_valid'][j]
            gts.append(dict(gt_boxes=bt['gt_boxes'][j][ov],
                            labels=bt['gt_labels'][j][ov]))
    infer_s = time.perf_counter() - t_inf
    got = counts(mods)
    n_fwd = -(-len(val_set) // batch)
    want = dict(IN_PER_STEP, gather_gemm_conv=IN_PER_STEP['gather_gemm_conv']
                * IF_FCAF3D_STEPS + IN_CONVS * n_fwd,
                gather_gemm_dw=IN_PER_STEP['gather_gemm_dw'] * IF_FCAF3D_STEPS)
    if got != want:
        fail(f'fcaf3d scannet: {IF_FCAF3D_STEPS} train steps and {n_fwd} '
             f'forwards launched {got}, expected {want}')
    for i, rec in enumerate(recs):
        n = {k: len(v) for k, v in rec.items() if v}
        if n != dict(gather_gemm_conv=IN_CONVS + IN_DGRAD,
                     gather_gemm_dw=IN_CONVS):
            fail(f'fcaf3d scannet: step {i + 1} launched {n}')
    o = cfg.optimizer
    sched = piecewise_constant_schedule(
        o.lr, {len(batches) * e: o.lr_gamma for e in o.lr_steps})
    for i, (lg, lr) in enumerate(zip(logs, lrs)):
        finite_logs(torch, lg, f'fcaf3d scannet step {i + 1}')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'fcaf3d scannet: step {i + 1} ran at lr {lr}, the '
                 f'schedule gives {sched(i)}')
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n])]
    stuck += [n for n, b in model.named_buffers()
              if n in stats0 and torch.equal(b, stats0[n])]
    if stuck:
        fail(f'fcaf3d scannet: {len(stuck)} tensors did not move: '
             f'{stuck[:8]}')
    ms = [a.elapsed_time(b) for a, b in step_ms]
    budgets = dict(voxels=model_cfg.max_voxels)
    for name, bud in zip(('conv1', 'pool', 'layer1', 'layer2', 'layer3',
                          'layer4'), model_cfg.backbone_budgets):
        budgets[name] = bud
    for i, bud in enumerate(head.level_budgets):
        budgets[f'head{i}'] = bud
    active = {k: [int(v) for d in diags for v in d[f'active.{k}'].tolist()]
              for k in budgets}
    res.update(steps=IF_FCAF3D_STEPS, step_device_ms=ms,
               launches=train_launches, peak_bytes=peak,
               losses=[float(lg['loss']) for lg in logs],
               num_pos=[float(lg['num_pos']) for lg in logs], lrs=lrs,
               active={k: dict(per_scene=active[k], budget=budgets[k])
                       for k in budgets})
    print(f'{card}: fcaf3d scannet: {IF_FCAF3D_STEPS} steps at B={batch}: '
          f'step device ms {[round(v, 1) for v in ms]}, peak '
          f'{peak / 2 ** 30:.2f} GiB, launches {train_launches}; losses '
          f'{[round(v, 4) for v in res["losses"]]}, num_pos '
          f'{res["num_pos"]}, lr {lrs}')
    print(f'{card}: fcaf3d scannet active sites a scene / budget (the '
          f'{IF_FCAF3D_STEPS} steps\' scenes): ' + ', '.join(
              f'{k} {min(v)}-{max(v)}/{budgets[k]}'
              for k, v in active.items()))

    # --- 2. every call against plain; step 1's timed ---------------------
    torch.set_grad_enabled(False)
    errs = [check_calls(torch, mods, rec, f'fcaf3d scannet step {i + 1}')
            for i, rec in enumerate(recs)]
    calls = recs[0]['gather_gemm_conv']
    conv_rows = [conv_row(torch, sparse_conv, *a, f'fcaf3d scannet call {i}')
                 for i, (_, a) in enumerate(calls)]
    print_conv_rows(f'fcaf3d scannet kernels: gather_gemm_conv f32 vs plain '
                    f'at step 1\'s {IN_CONVS} forward calls',
                    conv_rows[:IN_CONVS])
    print_conv_rows(f'fcaf3d scannet kernels: gather_gemm_conv f32 vs plain '
                    f'at step 1\'s {IN_DGRAD} input-gradient calls',
                    conv_rows[IN_CONVS:])
    dwr = dw_rows(torch, sparse_conv, recs[0]['gather_gemm_dw'],
                  'fcaf3d scannet kernels')
    torch.set_grad_enabled(True)
    del recs, calls

    # --- 3. the indoor eval ----------------------------------------------
    _, ap = indoor_eval(gts, dts, classes=CLASSES)
    missing = [k for k in ('mAP_0.25', 'mAP_0.50') if k not in ap]
    if missing:
        fail(f'fcaf3d scannet: indoor_eval gave no {missing}')
    res['eval'] = dict(scenes=len(val_set), infer_s=infer_s,
                       scenes_per_s=len(val_set) / infer_s,
                       detections=sum(len(d['scores']) for d in dts),
                       launches=IN_CONVS * n_fwd, ap=ap)
    res.update(conv_calls=conv_rows, dw_calls=dwr, max_errs=errs,
               seconds=time.perf_counter() - t0)
    print(f'{card}: fcaf3d scannet: infer_indoor on {len(val_set)} val '
          f'scenes {res["eval"]["scenes_per_s"]:.2f} scenes/s (host clock, '
          f'decode and the copy to the host included), '
          f'{res["eval"]["detections"]} detections; mAP_0.25 '
          f'{ap["mAP_0.25"]:.4g}, mAP_0.50 {ap["mAP_0.50"]:.4g}; the path '
          f'{res["seconds"]:.1f} s')
    del trainer, model
    torch.cuda.empty_cache()
    return res


def votenet_input(batch):
    """A dataset batch as VoteNet's input (numpy): the points' xyz and
    their height above the floor, z less the scene's 0.99th percentile
    of z (mmdet3d's ``LoadPointsFromFile(shift_height=True)``: neither
    gga_tpu nor the port has such a function, their datasets give xyz and
    colours), and the boxes moved from the datasets' gravity centres to
    the bottom centres VoteHead's targets read."""
    xyz = batch['points']
    floor = np.percentile(xyz[..., 2], 0.99, axis=-1)[:, None]
    boxes = batch['gt_boxes'].copy()
    boxes[..., 2] -= boxes[..., 5] / 2
    return dict(points=np.concatenate(
        [xyz, (xyz[..., 2] - floor)[..., None]], -1).astype(np.float32),
        points_valid=batch['points_valid'], gt_boxes=boxes,
        gt_labels=batch['gt_labels'], obj_valid=batch['obj_valid'])


@contextlib.contextmanager
def votenet_stage_events(torch, model):
    """CUDA events around the parts of each VoteNet step: every farthest
    point sampling and ball query (``ops/points.py``), each backbone set
    abstraction and feature propagation, and the head. Yields ``spans``,
    a list with one dict a step of {part: [(start, end), ...]}; append
    a dict before each step."""
    from gga_tpu_torch.ops import points as po
    spans = []
    in_head = [False]

    def add(key, pair):
        spans[-1].setdefault(key, []).append(pair)

    def timed(fn, key):
        def wrapper(*a, **k):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            add(f'{key}.{"head" if in_head[0] else "backbone"}', pair)
            return out
        return wrapper

    def hooks(module, key):
        pair = []

        def pre(*_):
            pair[:] = [torch.cuda.Event(enable_timing=True)
                       for _ in range(2)]
            pair[0].record()
            if key == 'head':
                in_head[0] = True

        def post(*_):
            pair[1].record()
            add(key, tuple(pair))
            if key == 'head':
                in_head[0] = False
        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]

    real = po.furthest_point_sample, po.ball_query
    po.furthest_point_sample = timed(real[0], 'fps')
    po.ball_query = timed(real[1], 'ball_query')
    handles = [h for sa in model.backbone.SA_modules for h in hooks(sa, 'sa')]
    handles += [h for fp in model.backbone.FP_modules
                for h in hooks(fp, 'fp')]
    handles += hooks(model.bbox_head, 'head')
    try:
        yield spans
    finally:
        po.furthest_point_sample, po.ball_query = real
        for h in handles:
            h.remove()


def votenet_stage_ms(spans, marks):
    """Device ms of one step by VN_STAGES from its spans and its marks
    (start, forward, loss, backward, optimizer events)."""
    def total(key):
        return sum(a.elapsed_time(b) for a, b in spans.get(key, []))
    sampling_bb = total('fps.backbone') + total('ball_query.backbone')
    sampling_head = total('fps.head') + total('ball_query.head')
    return {
        'FPS + ball query': sampling_bb + sampling_head,
        'SA MLPs': total('sa') - sampling_bb,
        'FP': total('fp'),
        'vote head': total('head') - sampling_head,
        'targets + loss': marks[1].elapsed_time(marks[2]),
        'backward': marks[2].elapsed_time(marks[3]),
        'clip + AdamW': marks[3].elapsed_time(marks[4])}


def votenet_path(torch, mods, card, data, config, dataset, steps, infer,
                 profile=False):
    """One VoteNet config as shipped (f32, B = ``data.samples_per_gpu`` x
    ``data.num_points`` points, the height channel of ``votenet_input``)
    on stage 1's infos of ``dataset``, seeded random weights:

    1. main path: ``steps`` calls of ``apis.votenet_train_step`` on the
       config's optimizer and schedule (the 3x schedule, the epochs of
       the train split at B), then, with ``infer``, ``apis.
       infer_votenet`` over the val split; the counts set to 0 just
       before and read just after: no kernel launched; every parameter
       and output on the card; finite losses with every term present
       (``iou_loss`` where its weight is set); each step's lr; every
       parameter and BN statistic moved (but zero-initialised tensors no
       gradient reached, printed); CUDA events by VN_STAGES, scenes/s by
       events, peak memory;
    2. with ``profile``, one more step under the profiler (the device's
       busy share);
    3. ``indoor_eval`` of the val split's detections at 0.25 / 0.5, the
       boxes moved back to gravity centres (the mAP keys);
    4. ungated, with ``infer``: one val scene's eval forward on the card
       against the same weights' forward on the CPU (the share of equal
       farthest-point-sampling indices, the largest difference of the
       proposals' centres)."""
    import copy

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.scannet import ScanNetDataset
    from gga_tpu_torch.data.sunrgbd import SunRgbdDataset
    from gga_tpu_torch.eval.indoor_eval import indoor_eval
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.ops import points as po
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    head = model_cfg.head
    label = f'votenet {Path(config).stem}'
    batch, n_points = cfg.data.samples_per_gpu, cfg.data.num_points
    ds_cls = SunRgbdDataset if dataset == 'sunrgbd' else ScanNetDataset
    root, pkls = data[dataset]['root'], data[dataset]['pkls']
    train_set = ds_cls(root, pkls['train'], num_points=n_points,
                       max_objs=head.max_objs)
    spe = len(train_set) // batch
    if not spe:
        fail(f'{label}: {len(train_set)} train scenes, fewer than B = '
             f'{batch}')
    trainer = apis.init_votenet_trainer(model_cfg, spe, device=DEVICE,
                                        seed=0, optimizer=dict(cfg.optimizer))
    model = trainer.model
    print(f'{label}: PointNet2SASSG {model_cfg.num_points} + VoteHead '
          f'({head.num_classes} classes, {head.num_dir_bins} direction '
          f'bins, iou_loss_weight {head.iou_loss_weight}), B = {batch} x '
          f'{n_points} points, f32, {spe} steps an epoch')
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    inputs = [votenet_input(b) for e in range(-(-steps // spe))
              for b in train_set.epoch_batches(batch, seed=e)][:steps]

    # --- 1. main path ----------------------------------------------------
    logs, lrs, marks, res = [], [], [], {}
    order = ('forward', 'loss', 'backward', 'optimizer')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    with votenet_stage_events(torch, model) as spans:
        for i in range(steps):
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ('start',) + order}
            spans.append({})
            ev['start'].record()
            logs.append(apis.votenet_train_step(
                trainer, inputs[i], lambda name, ev=ev: ev[name].record()))
            lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
            marks.append([ev[k] for k in ('start',) + order])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    train_launches = counts(mods)
    if any(train_launches.values()):
        fail(f'{label}: {steps} train steps launched {train_launches}; '
             'VoteNet reaches no hand kernel')
    terms = VN_TERMS + (('iou_loss',) if head.iou_loss_weight else ())
    sched = piecewise_constant_schedule(
        cfg.optimizer.lr, {spe * e: cfg.optimizer.lr_gamma
                           for e in cfg.optimizer.lr_steps})
    for i, (lg, lr) in enumerate(zip(logs, lrs)):
        if sorted(lg) != sorted(terms):
            fail(f'{label}: step {i + 1} logged {sorted(lg)}, expected '
                 f'{sorted(terms)}')
        if not all(v.device.type == DEVICE for v in lg.values()):
            fail(f'{label}: step {i + 1} logs off the card')
        finite_logs(torch, lg, f'{label} step {i + 1}')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'{label}: step {i + 1} ran at lr {lr}, the schedule gives '
                 f'{sched(i)}')
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n]) and bool(params0[n].any())]
    unreached = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n]) and not params0[n].any()]
    stuck += [n for n, b in model.named_buffers()
              if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
    if stuck:
        fail(f'{label}: {len(stuck)} tensors did not move: {stuck[:8]}')
    del params0, stats0
    step_ms = [m[0].elapsed_time(m[-1]) for m in marks]
    timed = list(range(1 if steps > 1 else 0, steps))
    stages = {k: float(np.mean([votenet_stage_ms(spans[i], marks[i])[k]
                                for i in timed])) for k in VN_STAGES}
    fps_ms = float(np.mean([sum(a.elapsed_time(b) for key in (
        'fps.backbone', 'fps.head') for a, b in spans[i].get(key, []))
        for i in timed]))
    res.update(steps=steps, batch=batch, points=n_points,
               step_device_ms=step_ms, stage_ms=stages, fps_ms=fps_ms,
               scenes_per_s_events=batch * len(timed) / (
                   sum(step_ms[i] for i in timed) / 1e3),
               peak_bytes=peak, launches=train_launches, lrs=lrs,
               unreached=unreached,
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {steps} steps at B={batch} (f32): step device '
          f'ms {[round(v, 1) for v in step_ms]}, '
          f'{res["scenes_per_s_events"]:.2f} scenes/s by CUDA events '
          f'(steps {[i + 1 for i in timed]}), peak '
          f'{peak / 2 ** 30:.2f} GiB; launches {train_launches}; lr {lrs}')
    print(f'{card}: {label}: device ms a step by stage (events, mean of '
          f'steps {[i + 1 for i in timed]}): ' + ', '.join(
              f'{k} {v:.1f}' for k, v in stages.items())
          + f'; farthest point sampling alone {fps_ms:.1f}')
    print(f'{label}: losses ' + ', '.join(
        f'{k} {[round(lg[k], 4) for lg in res["logs"]]}' for k in terms)
        + (f'; zero-initialised and unreached: {unreached}'
           if unreached else ''))

    # --- 2. the device's busy share of one more step ---------------------
    if profile:
        prof = device_profile(torch, lambda: apis.votenet_train_step(
            trainer, inputs[-1]))
        print_profile(f'{label} train step', prof)
        res['profile'] = prof

    if infer:
        # --- 1. (cont.) inference over the val split ---------------------
        val_set = ds_cls(root, pkls['val'], num_points=n_points,
                         max_objs=head.max_objs, test_mode=True)
        bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
        gts, dts, infer_s = [], [], 0.0
        zero_counts(mods)
        for bt in val_set.epoch_batches(batch, shuffle=False,
                                        drop_last=False):
            x = votenet_input(bt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            d = apis.infer_votenet(bundle, x['points'], x['points_valid'])
            if not all(v.device.type == DEVICE for v in d.values()):
                fail(f'{label}: infer_votenet gave tensors off the card')
            d = {k: v.cpu().numpy() for k, v in d.items()}
            infer_s += time.perf_counter() - t1
            for j in range(len(x['points'])):
                v = d['valid'][j]
                boxes = d['boxes'][j][v].copy()
                boxes[:, 2] += boxes[:, 5] / 2        # to gravity centres
                if not np.isfinite(boxes).all():
                    fail(f'{label}: non-finite kept boxes')
                dts.append(dict(boxes=boxes, labels=d['labels'][j][v],
                                scores=d['scores'][j][v]))
                ov = bt['obj_valid'][j]
                gts.append(dict(gt_boxes=bt['gt_boxes'][j][ov],
                                labels=bt['gt_labels'][j][ov]))
        got = counts(mods)
        if any(got.values()):
            fail(f'{label}: infer_votenet launched {got}')
        # --- 3. the indoor eval -----------------------------------------
        _, ap = indoor_eval(gts, dts, iou_thresholds=(0.25, 0.5),
                            classes=ds_cls.CLASSES)
        missing = [k for k in ('mAP_0.25', 'mAP_0.50') if k not in ap]
        if missing:
            fail(f'{label}: indoor_eval gave no {missing}')
        res['eval'] = dict(scenes=len(val_set), infer_s=infer_s,
                           scenes_per_s=len(val_set) / infer_s,
                           detections=sum(len(d['scores']) for d in dts),
                           ap=ap)
        print(f'{card}: {label}: infer_votenet on {len(val_set)} val scenes '
              f'{res["eval"]["scenes_per_s"]:.2f} scenes/s (host clock, '
              'decode, NMS and the copy to the host included), '
              f'{res["eval"]["detections"]} detections; mAP_0.25 '
              f'{ap["mAP_0.25"]:.4g}, mAP_0.50 {ap["mAP_0.50"]:.4g}')

        # --- 4. ungated: the card's forward against the CPU's ------------
        x = votenet_input(next(val_set.epoch_batches(1, shuffle=False)))
        sampled = dict(card=[], cpu=[])
        run = ['card']
        real = po.furthest_point_sample

        def keep(points, valid, num):
            out = real(points, valid, num)
            sampled[run[0]].append(out.cpu())
            return out

        cpu_model = copy.deepcopy(model).cpu().eval()
        po.furthest_point_sample = keep
        try:
            with torch.no_grad():
                card_out = model.eval()(*(torch.as_tensor(
                    x[k], device=DEVICE) for k in ('points', 'points_valid')))
                run[0] = 'cpu'
                cpu_out = cpu_model(*(torch.as_tensor(x[k]) for k in (
                    'points', 'points_valid')))
        finally:
            po.furthest_point_sample = real
        same = [float((a == b).float().mean())
                for a, b in zip(sampled['card'], sampled['cpu'])]
        res['card_vs_cpu'] = dict(
            fps_equal_share=same,
            max_abs_center=float((card_out['center'].cpu()
                                  - cpu_out['center']).abs().max()),
            max_abs_agg_xyz=float((card_out['agg_xyz'].cpu()
                                   - cpu_out['agg_xyz']).abs().max()),
            max_abs_obj=float((card_out['obj'].cpu()
                               - cpu_out['obj']).abs().max()))
        print(f'{label}: one val scene, the card\'s forward against the '
              'CPU\'s (not gated): share of equal FPS indices a sampling '
              f'{[round(s, 4) for s in same]}, max |d| of the proposal '
              f'centres {res["card_vs_cpu"]["max_abs_center"]:.3g} m, '
              f'objectness logits {res["card_vs_cpu"]["max_abs_obj"]:.3g}')
        del cpu_model, card_out, cpu_out
    res['seconds'] = time.perf_counter() - t0
    print(f'{label}: the path {res["seconds"]:.1f} s')
    del trainer, model
    torch.cuda.empty_cache()
    return res


def indoor_family_phase(torch, mods, card, tmp):
    """Stage 1 for SUN RGB-D and ScanNet (``indoor_stage1``), FCAF3D on
    ScanNet (``fcaf3d_scannet``) and VoteNet on each IF_VOTENET config
    (``votenet_path``; the SUN RGB-D one profiled)."""
    t0 = time.perf_counter()
    data, res = indoor_stage1(torch, card, tmp)
    res['fcaf3d_scannet'] = fcaf3d_scannet(torch, mods, card,
                                           data['scannet'])
    res['votenet'] = {}
    for i, (config, dataset, steps, infer) in enumerate(IF_VOTENET):
        res['votenet'][Path(config).stem] = votenet_path(
            torch, mods, card, data, config, dataset, steps, infer,
            profile=i == 0)
    res['seconds'] = time.perf_counter() - t0
    res['data'] = data
    print(f'indoor family phase: {res["seconds"]:.1f} s')
    return res


# --- the VoteNet-derived indoor detectors: GroupFree3D, H3DNet and
#     ImVoteNet on the indoor family's mini ScanNet and SUN RGB-D --------
# (config, kind, train): the widest GroupFree3D config runs one eval
# forward against the CPU's and one inference only
VD_PATHS = (
    ('configs/groupfree3d/groupfree3d_8x4_scannet-3d-18class-L6-O256.py',
     'groupfree3d', True),
    ('configs/groupfree3d/groupfree3d_8x4_scannet-3d-18class-w2x-L12-O512'
     '.py', 'groupfree3d', False),
    ('configs/h3dnet/h3dnet_3x8_scannet-3d-18class.py', 'h3dnet', True),
    ('configs/imvotenet/imvotenet_stage2_16x8_sunrgbd-3d-10class.py',
     'imvotenet', True))
VD_STEPS = 1                # recorded train steps of each trained detector
VD_TOL = 1e-4               # card forward against the CPU's, of max|CPU|
VD_MAX_OBJS = 64            # box slots a scene
VD_DISTRACTORS = 8          # seeded 2D boxes a scene beside the projections
VD_STAGES = ('FPS', 'ball query + grouping', 'backbone MLPs', 'heads',
             'targets + loss', 'backward', 'clip + AdamW')
# the log that counts the positives of each detector's step
VD_NUM_POS = dict(groupfree3d='num_pos', h3dnet='refined.num_pos',
                  imvotenet='num_pos')


def sunrgbd_depth2img(info):
    """A SUN RGB-D info's depth -> image projection [4, 4] from its calib
    (mmdet3d's SUNRGBDDataset: K @ flip @ Rt^T, the flip taking depth's
    (x, y, z) to the camera's (x, -z, y))."""
    calib = info['calib']
    flip = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.asarray(calib['K'], np.float64) @ flip @ np.asarray(
        calib['Rt'], np.float64).T
    return m


def image_inputs(rng, gt_boxes, gt_labels, obj_valid, d2i, shape):
    """ImVoteNet's image inputs of one scene: a seeded uint8 image of
    ``shape``, and as 2D boxes each valid box's projection (its 8
    corners' extent clipped to the image, confidence 1, its class) where
    all its corners lie 0.1 m or more in front of the camera, then
    VD_DISTRACTORS seeded boxes (confidence 0.2-0.9, a random class).
    Returns (image [H, W, 3], boxes [M + D, 6], valid [M + D])."""
    H, W = shape
    img = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    M = len(gt_boxes)
    boxes = np.zeros((M + VD_DISTRACTORS, 6), np.float32)
    valid = np.zeros(M + VD_DISTRACTORS, bool)
    for i in np.flatnonzero(obj_valid):
        x, y, z, dx, dy, dz, yaw = gt_boxes[i]
        c, s = np.cos(yaw), np.sin(yaw)
        corners = []
        for sx in (-0.5, 0.5):
            for sy in (-0.5, 0.5):
                for sz in (-0.5, 0.5):
                    corners.append([x + sx * dx * c - sy * dy * s,
                                    y + sx * dx * s + sy * dy * c,
                                    z + sz * dz, 1.0])
        uvz = np.asarray(corners) @ d2i.T
        if uvz[:, 2].min() < 0.1:
            continue
        uv = uvz[:, :2] / uvz[:, 2:3]
        lo = np.clip(uv.min(0), 0, [W - 1, H - 1])
        hi = np.clip(uv.max(0), 0, [W - 1, H - 1])
        if (hi > lo).all():
            boxes[i] = [*lo, *hi, 1.0, gt_labels[i]]
            valid[i] = True
    lo = rng.uniform(0, [W - 120, H - 120], (VD_DISTRACTORS, 2))
    boxes[M:, :2] = lo
    boxes[M:, 2:4] = lo + rng.uniform(30, 120, (VD_DISTRACTORS, 2))
    boxes[M:, 4] = rng.uniform(0.2, 0.9, VD_DISTRACTORS)
    boxes[M:, 5] = rng.randint(0, 10, VD_DISTRACTORS)
    valid[M:] = True
    return img, boxes, valid


def vote_derived_batches(ds, batch, kind, seed, test_mode=False):
    """The batches of ``ds`` as the detector's inputs (numpy): VoteNet's
    ``votenet_input`` (xyz and the height, bottom-centre boxes), xyz alone
    for GroupFree3D, and for ImVoteNet the images, 2D boxes and
    projections of ``image_inputs`` from each scene's info (the scenes
    in ``epoch_batches``' order for ``seed``)."""
    order = np.arange(len(ds))
    if not test_mode:
        np.random.RandomState(seed or 0).shuffle(order)
    rng = np.random.RandomState(100 + seed)
    out = []
    for i in range(0, len(order) // batch * batch, batch):
        idx = order[i:i + batch]
        items = [ds[j] for j in idx]
        b = votenet_input({k: np.stack([it[k] for it in items])
                           for k in items[0]})
        b['gt_valid'] = b.pop('obj_valid')
        if kind == 'groupfree3d':
            b['points'] = np.ascontiguousarray(b['points'][..., :3])
        if kind == 'imvotenet':
            d2i = np.stack([sunrgbd_depth2img(ds.infos[j]) for j in idx])
            shape = tuple(ds.infos[idx[0]]['image']['image_shape'])
            # the 2D boxes from the gravity-centred boxes of the scene
            grav = b['gt_boxes'].copy()
            grav[..., 2] += grav[..., 5] / 2
            ims = [image_inputs(rng, g, lab, v, m, shape) for g, lab, v, m
                   in zip(grav, b['gt_labels'], b['gt_valid'], d2i)]
            b.update(img=np.stack([x[0] for x in ims]),
                     boxes_2d=np.stack([x[1] for x in ims]),
                     boxes_valid=np.stack([x[2] for x in ims]),
                     depth2img=d2i)
        out.append(b)
    return out


VD_INPUTS = ('points', 'points_valid', 'img', 'boxes_2d', 'boxes_valid',
             'depth2img')


def vd_forward(torch, model, kind, batch, device, seed_u, sample_idx=None):
    """One forward of ``model`` (in its mode) on ``batch`` (numpy) on
    ``device``; the output as a dict (ImVoteNet's towers by name)."""
    args = [torch.as_tensor(batch[k], device=device) for k in VD_INPUTS
            if k in batch]
    if kind == 'imvotenet':
        out = model(*args, seed_u.to(device), sample_idx=sample_idx)
        return dict(zip(('joint', 'pts', 'img'), out))
    return model(*args, sample_idx=sample_idx)


def vd_to(torch, idx, device):
    if isinstance(idx, dict):
        return {k: vd_to(torch, v, device) for k, v in idx.items()}
    if isinstance(idx, list):
        return [vd_to(torch, v, device) for v in idx]
    return idx.to(device)


def vd_level0(kind, idx):
    """The level-0 farthest point sampling indices of each tower."""
    bb = idx['backbone']
    return [t[0] for t in bb] if kind == 'h3dnet' else [bb[0]]


def vd_pick_shares(torch, card, ref, name=''):
    """The share of each site's picks the card makes alone equal to the
    CPU's."""
    if isinstance(ref, dict):
        return {k: v for key in ref for k, v in vd_pick_shares(
            torch, card[key], ref[key], f'{name}{key}.').items()}
    if isinstance(ref, list):
        return {k: v for i, (c, r) in enumerate(zip(card, ref))
                for k, v in vd_pick_shares(torch, c, r,
                                           f'{name}{i}.').items()}
    return {name[:-1]: float((card.cpu() == ref).float().mean())}


def vd_card_vs_cpu(torch, model, kind, batch, seed_u, label):
    """The card's eval forward against the same weights' on the CPU, on
    the first scene of ``batch`` (B = 1: the CPU forward of the full-width
    towers is the phase's largest host cost): every tower's level-0
    farthest point sampling the card does alone must equal the CPU's;
    with the CPU's picks given (every sampling, KPS and ImVoteNet's seed
    rows), every output within VD_TOL of the CPU's largest entry and the
    integer outputs equal. Prints, ungated, the share of each site's
    picks the card makes alone that equal the CPU's."""
    import copy
    one = {k: v[:1] for k, v in batch.items()}
    u = None if seed_u is None else seed_u[:1]
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = vd_forward(torch, cpu_model, kind, one, 'cpu', u)
        cpu_s = time.perf_counter() - t0
        ref_idx = cpu_model.sampled_indices(ref)
        alone = vd_forward(torch, model, kind, one, DEVICE, u)
        card_idx = model.sampled_indices(alone)
        given = vd_forward(torch, model, kind, one, DEVICE, u,
                           vd_to(torch, ref_idx, DEVICE))
    if not all(torch.equal(c.cpu(), r) for c, r in zip(
            vd_level0(kind, card_idx), vd_level0(kind, ref_idx))):
        fail(f'{label}: the card\'s level-0 FPS indices differ from the '
             'CPU\'s')
    share = vd_pick_shares(torch, card_idx, ref_idx)
    diffs, equal = max_rel_diff(torch, given, ref)
    worst = max((v for v in diffs.values() if isinstance(v, float)),
                default=0.0)
    print(f'{label}: eval forward at B = 1, card against CPU (TF32 off, the '
          f'CPU\'s picks given): max |d| / max|CPU| {worst:.3g} (gate '
          f'{VD_TOL}), integer and mask outputs '
          f'{"equal" if equal else "DIFFER"}; the picks the card makes '
          'alone equal to the CPU\'s (not gated): ' + ', '.join(
              f'{k} {v:.4f}' for k, v in share.items())
          + f'; the CPU forward {cpu_s:.1f} s')
    if not equal or worst > VD_TOL:
        bad = {k: v for k, v in diffs.items()
               if not isinstance(v, float) or v > VD_TOL}
        fail(f'{label}: card forward against the CPU: {bad}')
    del cpu_model
    return dict(max_rel_diff=worst, pick_share=share, cpu_forward_s=cpu_s)


@contextlib.contextmanager
def vote_derived_stage_events(torch, backbone):
    """CUDA events around every farthest point sampling and grouping
    (``ops/points.py``) of a forward, each marked as in the backbone
    (``backbone``'s forward, also timed) or in the heads. Yields
    ``spans``, a list with one dict a step of {part: [(start, end),
    ...]}; append a dict before each step."""
    from gga_tpu_torch.ops import points as po
    spans = []
    where = ['heads']

    def add(key, pair):
        spans[-1].setdefault(key, []).append(pair)

    def timed(fn, key):
        def wrapper(*a, **k):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            add(f'{key}.{where[0]}', pair)
            return out
        return wrapper

    pair = []

    def pre(*_):
        pair[:] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        where[0] = 'backbone'

    def post(*_):
        pair[1].record()
        add('backbone', tuple(pair))
        where[0] = 'heads'

    real = po.furthest_point_sample, po.query_and_group
    po.furthest_point_sample = timed(real[0], 'fps')
    po.query_and_group = timed(real[1], 'grouping')
    handles = [backbone.register_forward_pre_hook(pre),
               backbone.register_forward_hook(post)]
    try:
        yield spans
    finally:
        po.furthest_point_sample, po.query_and_group = real
        for h in handles:
            h.remove()


def vote_derived_stage_ms(spans, marks):
    """Device ms of one step by VD_STAGES from its spans and its marks
    (start, forward, loss, backward, optimizer events)."""
    def total(*keys):
        return sum(a.elapsed_time(b) for k in keys for a, b in spans.get(k,
                                                                          []))
    in_bb = total('fps.backbone', 'grouping.backbone')
    in_heads = total('fps.heads', 'grouping.heads')
    return {'FPS': total('fps.backbone', 'fps.heads'),
            'ball query + grouping': total('grouping.backbone',
                                           'grouping.heads'),
            'backbone MLPs': total('backbone') - in_bb,
            'heads': (marks[0].elapsed_time(marks[1]) - total('backbone')
                      - in_heads),
            'targets + loss': marks[1].elapsed_time(marks[2]),
            'backward': marks[2].elapsed_time(marks[3]),
            'clip + AdamW': marks[3].elapsed_time(marks[4])}


def vote_derived_path(torch, mods, card, data, config, kind, train):
    """One VoteNet-derived detector (``config`` as shipped, f32, seeded
    random weights) on the indoor family's mini ScanNet (GroupFree3D,
    H3DNet) or SUN RGB-D (ImVoteNet, with ``vote_derived_batches``'
    images, 2D boxes and projections) at the config's B and
    ``num_points``:

    1. the card's eval forward against the CPU's (``vd_card_vs_cpu``);
    2. with ``train``, main path: VD_STEPS calls of the detector's
       ``apis.*_train_step`` on the config's optimizer and schedule, the
       counts set to 0 just before and read just after: no kernel
       launched, finite losses, positives (VD_NUM_POS) > 0, each step's
       lr the schedule's, every parameter and BN statistic moved (but
       zero-initialised biases no gradient reached, printed); CUDA events
       by VD_STAGES, the FPS share of a step, scenes/s by events, peak
       memory;
    3. one ``apis.infer_*`` call on a test-mode batch of the train split
       (SUN RGB-D's val split holds fewer scenes than B = 16): no launch,
       finite boxes [B, n, 7]."""
    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.scannet import ScanNetDataset
    from gga_tpu_torch.data.sunrgbd import SunRgbdDataset
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.models.detectors.imvotenet import imvotenet_draws
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    label = f'{kind} {Path(config).stem}'
    batch, n_points = cfg.data.samples_per_gpu, cfg.data.num_points
    sun = kind == 'imvotenet'
    ds_cls = SunRgbdDataset if sun else ScanNetDataset
    d = data['sunrgbd' if sun else 'scannet']
    train_set = ds_cls(d['root'], d['pkls']['train'], num_points=n_points,
                       max_objs=VD_MAX_OBJS)
    test_set = ds_cls(d['root'], d['pkls']['train'], num_points=n_points,
                      max_objs=VD_MAX_OBJS, test_mode=True)
    spe = len(train_set) // batch
    if not spe:
        fail(f'{label}: {len(train_set)} train scenes, fewer than B = '
             f'{batch}')
    init = getattr(apis, f'init_{kind}_trainer' if train
                   else f'init_{kind}_detector')
    opt = dict(cfg.optimizer)
    bundle = (init(model_cfg, spe, device=DEVICE, seed=0, optimizer=opt)
              if train else init(model_cfg, device=DEVICE, seed=0))
    model = bundle.model
    print(f'{label}: B = {batch} x {n_points} points, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters'
          + (f', {spe} steps an epoch' if train else ''))
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    res = dict(config=Path(config).name, batch=batch, points=n_points)
    gen = torch.Generator().manual_seed(1)
    batches = [b for e in range(-(-VD_STEPS // spe) if train else 1)
               for b in vote_derived_batches(train_set, batch, kind, e)]
    seed_u = imvotenet_draws(model_cfg, batch, gen, 'cpu') if sun else None

    # --- 1. the card's eval forward against the CPU's --------------------
    res['card_vs_cpu'] = vd_card_vs_cpu(torch, model, kind, batches[0],
                                        seed_u, label)

    if train:
        # --- 2. main path -------------------------------------------------
        trainer = bundle
        step_fn = getattr(apis, f'{kind}_train_step')
        sched = piecewise_constant_schedule(
            opt['lr'], {spe * e: opt['lr_gamma'] for e in opt['lr_steps']})
        params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        stats0 = {n: b.clone() for n, b in model.named_buffers()}
        logs, lrs, marks = [], [], []
        order = ('forward', 'loss', 'backward', 'optimizer')
        backbone = model.pts_backbone if sun else model.backbone
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(mods)
        with vote_derived_stage_events(torch, backbone) as spans:
            for i in range(VD_STEPS):
                ev = {k: torch.cuda.Event(enable_timing=True)
                      for k in ('start',) + order}
                spans.append({})
                ev['start'].record()
                logs.append(step_fn(trainer, batches[i],
                                    lambda name, ev=ev: ev[name].record()))
                lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
                marks.append([ev[k] for k in ('start',) + order])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launches = counts(mods)
        if any(launches.values()):
            fail(f'{label}: {VD_STEPS} train steps launched {launches}; the '
                 'VoteNet-derived detectors reach no hand kernel')
        for i, (lg, lr) in enumerate(zip(logs, lrs)):
            finite_logs(torch, lg, f'{label} step {i + 1}')
            if not all(v.device.type == DEVICE for v in lg.values()):
                fail(f'{label}: step {i + 1} logs off the card')
            if not float(lg[VD_NUM_POS[kind]]) > 0:
                fail(f'{label}: step {i + 1} met no positive')
            if not abs(lr - sched(i)) <= 1e-12 * sched(i):
                fail(f'{label}: step {i + 1} ran at lr {lr}, the schedule '
                     f'gives {sched(i)}')
        stuck = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n]) and bool(params0[n].any())]
        unreached = [n for n, p in model.named_parameters()
                     if torch.equal(p, params0[n]) and not params0[n].any()]
        stuck += [n for n, b in model.named_buffers()
                  if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
        if stuck:
            fail(f'{label}: {len(stuck)} tensors did not move: {stuck[:8]}')
        del params0, stats0
        step_ms = [m[0].elapsed_time(m[-1]) for m in marks]
        timed = list(range(1, VD_STEPS)) or [0]
        stages = {k: float(np.mean([vote_derived_stage_ms(
            spans[i], marks[i])[k] for i in timed])) for k in VD_STAGES}
        fps_share = stages['FPS'] / float(np.mean([step_ms[i]
                                                   for i in timed]))
        res.update(steps=VD_STEPS, step_device_ms=step_ms, stage_ms=stages,
                   fps_share=fps_share, peak_bytes=peak, launches=launches,
                   lrs=lrs, unreached=unreached,
                   scenes_per_s_events=batch * len(timed) / (
                       sum(step_ms[i] for i in timed) / 1e3),
                   logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
        print(f'{card}: {label}: {VD_STEPS} steps at B={batch} (f32): step '
              f'device ms {[round(v, 1) for v in step_ms]}, '
              f'{res["scenes_per_s_events"]:.2f} scenes/s by CUDA events '
              f'(steps {[i + 1 for i in timed]}), FPS '
              f'{100 * fps_share:.1f} % of a step, peak '
              f'{peak / 2 ** 30:.2f} GiB; launches {launches}; lr {lrs}')
        print(f'{card}: {label}: device ms a step by stage (events, steps '
              f'{[i + 1 for i in timed]}): ' + ', '.join(
                  f'{k} {v:.1f}' for k, v in stages.items()))
        print(f'{label}: losses ' + ', '.join(
            f'{k} {[round(lg[k], 4) for lg in res["logs"]]}'
            for k in res['logs'][0])
            + (f'; zero-initialised and unreached: {unreached}'
               if unreached else ''))
        bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))

    # --- 3. one inference call -------------------------------------------
    x = vote_derived_batches(test_set, batch, kind, 0, test_mode=True)[0]
    infer = getattr(apis, f'infer_{kind}')
    args = [x[k] for k in VD_INPUTS if k in x]
    zero_counts(mods)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    det = infer(bundle, *args)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    got = counts(mods)
    if any(got.values()):
        fail(f'{label}: inference launched {got}')
    boxes = det['boxes']
    head = model_cfg.rpn if kind == 'h3dnet' else model_cfg.head
    n_out = (min(head.max_out, head.num_proposal) if kind == 'groupfree3d'
             else head.max_out)
    if tuple(boxes.shape) != (batch, n_out, 7) or boxes.device.type != DEVICE:
        fail(f'{label}: inference gave boxes {tuple(boxes.shape)} on '
             f'{boxes.device}, expected ({batch}, {n_out}, 7) on the card')
    if not torch.isfinite(boxes).all():
        fail(f'{label}: non-finite boxes')
    res['infer'] = dict(seconds=infer_s, scenes_per_s=batch / infer_s,
                        kept=int(det['valid'].sum()), launches=got)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: one inference call on {batch} scenes '
          f'{infer_s * 1e3:.1f} ms = {batch / infer_s:.2f} scenes/s (host '
          f'clock, decode and NMS included), {res["infer"]["kept"]} boxes '
          f'kept; the path {res["seconds"]:.1f} s')
    del bundle, model
    torch.cuda.empty_cache()
    return res


def vote_derived_phase(torch, mods, card, data):
    """GroupFree3D, H3DNet and ImVoteNet (``vote_derived_path`` on each
    VD_PATHS config) on the indoor family's stage-1 data (``data``, its
    roots and pkls)."""
    t0 = time.perf_counter()
    res = {Path(config).stem: vote_derived_path(torch, mods, card, data,
                                                config, kind, train)
           for config, kind, train in VD_PATHS}
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: vote-derived phase: {res["seconds"]:.1f} s')
    return res


# --- the point-cloud segmentors: PointNet++ SSG and MSG, DGCNN and PAConv
#     on the indoor family's mini ScanNet and a mini S3DIS ----------------
SEG_PATHS = (
    'configs/pointnet2/pointnet2_ssg_16x2_cosine_200e_scannet_seg-3d-20class.py',
    'configs/pointnet2/pointnet2_msg_16x2_cosine_80e_s3dis_seg-3d-13class.py',
    'configs/dgcnn/dgcnn_32x4_cosine_100e_s3dis_seg-3d-13class.py',
    'configs/paconv/paconv_ssg_8x8_cosine_150e_s3dis_seg-3d-13class.py',
)
# rooms of the raw mini S3DIS: the configs train on Area_1 and test on
# Area_5; Area_1's 8 x 40 000 points give 78 resampled scene indices at
# 4 096 points, two steps of DGCNN's B = 32
SEG_S3DIS_ROOMS = dict(Area_1=8, Area_5=2)
SEG_S3DIS_POINTS = 40000
SEG_STEPS = 2               # recorded train steps of each segmentor
SEG_TOL = 1e-4              # card forward against the CPU's, of max|CPU|
SEG_WHOLE_POINTS = 40000    # inference_segmentor's max_points (its default)
SEG_STAGES = ('FPS + ball query + grouping', 'kNN graph', 'MLPs / PAConv',
              'head', 'loss', 'backward', 'clip + AdamW')
# S3DIS's furniture and fittings written into the rooms: table, chair,
# sofa, bookcase, board, window, door, clutter, beam, column
S3DIS_OBJECTS = (7, 8, 9, 10, 11, 5, 6, 12, 3, 4)


def write_raw_s3dis(root, rooms=SEG_S3DIS_ROOMS, n_points=SEG_S3DIS_POINTS,
                    seed=0):
    """S3DIS's raw layout under ``root`` (``s3dis_data/Area_{a}_room_{r}
    _{point, sem_label, ins_label}.npy``): box rooms of floor (class 1),
    ceiling (0) and walls (2), instance 0, three fifths of the points,
    and 4-8 objects of ``S3DIS_OBJECTS`` standing on the floor, one
    instance each; xyz in metres and rgb in 0-255 by class with noise.
    Returns {room stem: number of objects}."""
    import os
    rng = np.random.RandomState(seed)
    data = os.path.join(root, 's3dis_data')
    os.makedirs(data, exist_ok=True)
    colours = rng.uniform(30, 225, (13, 3))
    written = {}
    for area, n_rooms in rooms.items():
        for r in range(n_rooms):
            size = rng.uniform([4.0, 3.0, 2.6], [8.0, 6.0, 3.2])
            classes = rng.choice(S3DIS_OBJECTS, rng.randint(4, 9))
            n_obj = n_points * 2 // 5 // len(classes)
            n_bg = n_points - n_obj * len(classes)
            # the structure: floor, ceiling and the four walls
            part = rng.choice(6, n_bg, p=[0.3, 0.2, 0.125, 0.125, 0.125,
                                          0.125])
            xyz = rng.uniform(0, 1, (n_bg, 3)) * size
            xyz[part == 0, 2] = 0.0
            xyz[part == 1, 2] = size[2]
            for w, (axis, side) in enumerate(((0, 0), (0, 1), (1, 0),
                                              (1, 1)), 2):
                xyz[part == w, axis] = side * size[axis]
            sem = np.where(part == 0, 1, np.where(part == 1, 0, 2))
            ins = np.zeros(n_bg, np.int64)
            pts, sems, inss = [xyz], [sem], [ins]
            for i, cls in enumerate(classes, 1):
                dims = rng.uniform([0.4, 0.4, 0.4], [1.6, 1.2, 1.8])
                lo = rng.uniform(0, 1, 3) * (size - dims)
                lo[2] = 0.0
                pts.append(lo + rng.uniform(0, 1, (n_obj, 3)) * dims)
                sems.append(np.full(n_obj, cls))
                inss.append(np.full(n_obj, i, np.int64))
            sem = np.concatenate(sems).astype(np.int64)
            rgb = np.clip(colours[sem] + rng.randn(len(sem), 3) * 12, 0, 255)
            stem = f'{area}_room_{r + 1}'
            for suffix, arr in (
                    ('point', np.concatenate([np.concatenate(pts), rgb],
                                             -1).astype(np.float32)),
                    ('sem_label', sem), ('ins_label', np.concatenate(inss))):
                np.save(os.path.join(data, f'{stem}_{suffix}.npy'), arr)
            written[stem] = len(classes)
    return written


def s3dis_stage1(card, tmp):
    """The raw mini S3DIS written and converted by ``create_data.main``:
    one pkl an area, the seg_info label weights and resampled scene
    indices. Returns dict(root, pkls)."""
    import os

    from gga_tpu_torch.tools import create_data
    root = os.path.join(tmp, 's3dis_raw')
    t0 = time.perf_counter()
    written = write_raw_s3dis(root, SEG_S3DIS_ROOMS, SEG_S3DIS_POINTS)
    t1 = time.perf_counter()
    pkls = create_data.main(['s3dis', '--root-path', root, '--out-dir', root,
                             '--workers', str(IF_WORKERS)])
    t2 = time.perf_counter()
    if set(pkls) != set(SEG_S3DIS_ROOMS):
        fail(f'stage 1 s3dis: pkls of {sorted(pkls)}, expected '
             f'{sorted(SEG_S3DIS_ROOMS)}')
    for area in SEG_S3DIS_ROOMS:
        for f in ('resampled_scene_idxs', 'label_weight'):
            if not os.path.exists(os.path.join(root, 'seg_info',
                                               f'{area}_{f}.npy')):
                fail(f'stage 1 s3dis: no seg_info {area}_{f}')
    print(f'{card}: stage 1 s3dis: raw layout of {len(written)} rooms x '
          f'{SEG_S3DIS_POINTS} points written in {t1 - t0:.2f} s, '
          f'create_data s3dis --workers {IF_WORKERS} in {t2 - t1:.3f} s '
          '(host)')
    return dict(root=root, pkls=pkls)


def seg_scene_max(ds):
    """Each scene's per-axis maximum of xyz, from its whole points file."""
    import os
    return [np.fromfile(os.path.join(ds.root, i['pts_path']), np.float32)
            .reshape(-1, ds.load_dim)[:, :3].max(0) for i in ds.infos]


def seg_batch(ds, idxs, nine, maxes):
    """``ds``'s samples of the scenes ``idxs`` (each sample a draw of the
    dataset's RandomState) stacked; with ``nine``, mmdet3d's S3DIS
    input, built here: xyz | rgb | xyz over the scene's per-axis
    maximum."""
    out = []
    for j in idxs:
        s = ds[int(j)]
        if nine:
            s['points'] = np.concatenate(
                [s['points'], s['points'][:, :3] / maxes[int(j)]],
                -1).astype(np.float32)
        out.append(s)
    return {k: np.stack([s[k] for s in out]) for k in out[0]}


@contextlib.contextmanager
def seg_stage_events(torch, model):
    """CUDA events around every farthest point sampling, ball query +
    grouping (``ops/points.py``) and DGCNN kNN graph of a forward, and
    around ``model.decode_head``. Yields ``spans``, a list with one dict a
    step of {part: [(start, end), ...]}; append a dict before each
    step."""
    from gga_tpu_torch.models.backbones import dgcnn
    from gga_tpu_torch.ops import points as po
    spans, head = [], []

    def timed(fn, key):
        def wrapper(*a, **k):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            spans[-1].setdefault(key, []).append(pair)
            return out
        return wrapper

    def pre(*_):
        head[:] = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        head[0].record()

    def post(*_):
        head[1].record()
        spans[-1].setdefault('head', []).append(tuple(head))

    real = po.furthest_point_sample, po.query_and_group, dgcnn.masked_knn_graph
    po.furthest_point_sample = timed(real[0], 'fps')
    po.query_and_group = timed(real[1], 'grouping')
    dgcnn.masked_knn_graph = timed(real[2], 'knn')
    handles = [model.decode_head.register_forward_pre_hook(pre),
               model.decode_head.register_forward_hook(post)]
    try:
        yield spans
    finally:
        (po.furthest_point_sample, po.query_and_group,
         dgcnn.masked_knn_graph) = real
        for h in handles:
            h.remove()


def seg_stage_ms(spans, marks):
    """Device ms of one step by SEG_STAGES (and 'FPS' alone) from its spans
    and its marks (start, forward, loss, backward, optimizer events)."""
    def total(*keys):
        return sum(a.elapsed_time(b) for k in keys for a, b in spans.get(k,
                                                                          []))
    fwd = marks[0].elapsed_time(marks[1])
    return {'FPS + ball query + grouping': total('fps', 'grouping'),
            'kNN graph': total('knn'),
            'MLPs / PAConv': fwd - total('fps', 'grouping', 'knn', 'head'),
            'head': total('head'),
            'loss': marks[1].elapsed_time(marks[2]),
            'backward': marks[2].elapsed_time(marks[3]),
            'clip + AdamW': marks[3].elapsed_time(marks[4]),
            'FPS': total('fps')}


def seg_card_vs_cpu(torch, model, kind, batch, label):
    """The card's eval forward against the same weights' on the CPU, on the
    first scene of ``batch``: the picks the card makes alone that key on
    the input alone (every FPS level; DGCNN's D-KNN graph on the input's
    last three channels) must equal the CPU's; with all the CPU's picks
    given (DGCNN's F-KNN graphs key on learned features, whose last bits
    differ), the logits within SEG_TOL of the CPU's largest. Prints,
    ungated, the share of each pick site the card makes alone that equal
    the CPU's."""
    import copy
    pts = torch.as_tensor(batch['points'][:1])
    val = torch.as_tensor(batch['points_valid'][:1])
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu_model(pts, val)
        cpu_s = time.perf_counter() - t0
        ref_picks = cpu_model.last_picks
        model(pts.to(DEVICE), val.to(DEVICE))
        card_picks = [p.cpu() for p in model.last_picks]
        given = model(pts.to(DEVICE), val.to(DEVICE),
                      picks=[p.to(DEVICE) for p in ref_picks]).cpu()
    gated = [0] if kind == 'DGCNNSegmentor' else range(len(ref_picks))
    if not all(torch.equal(card_picks[i], ref_picks[i]) for i in gated):
        fail(f'{label}: the card\'s input-keyed picks differ from the CPU\'s')
    share = [float((c == r).float().mean())
             for c, r in zip(card_picks, ref_picks)]
    err = float((given - ref).abs().max()) / max(float(ref.abs().max()),
                                                 1e-30)
    print(f'{label}: eval forward at B = 1, card against CPU (TF32 off, the '
          f'CPU\'s picks given): max |d| / max|CPU| {err:.3g} (gate '
          f'{SEG_TOL}); the picks the card makes alone equal to the CPU\'s '
          f'(not gated but the input-keyed ones): '
          f'{[round(s, 4) for s in share]}; the CPU forward {cpu_s:.1f} s')
    if not err <= SEG_TOL:
        fail(f'{label}: card forward against the CPU: {err}')
    del cpu_model
    return dict(max_rel_diff=err, pick_share=share, cpu_forward_s=cpu_s)


# the stage marks of a train step (``recorded_steps``)
STEP_STAGES = ('forward', 'loss', 'backward', 'optimizer')


def recorded_steps(torch, mods, trainer, step_fn, batches, label,
                   record=()):
    """Main path: ``step_fn(trainer, batch, mark)`` on each batch (on the
    card), the counts set to 0 just before and read just after, CUDA
    events at the stage marks; the calls of the wrappers in ``record``
    ((module, name) pairs) recorded with the stage each came in.
    Returns (logs, lrs, marks, launches, peak bytes, recorded calls)."""
    stage = ['forward']
    logs, lrs, marks = [], [], []
    with contextlib.ExitStack() as stack:
        rec = {name: stack.enter_context(recording(mod, name,
                                                   lambda: stage[0]))
               for mod, name in record}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(mods)
        for b in batches:
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ('start',) + STEP_STAGES}

            def mark(name, ev=ev):
                ev[name].record()
                stage[0] = STEP_STAGES[min(STEP_STAGES.index(name) + 1,
                                           len(STEP_STAGES) - 1)]
            stage[0] = 'forward'
            ev['start'].record()
            logs.append(step_fn(trainer, b, mark))
            lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
            marks.append([ev[k] for k in ('start',) + STEP_STAGES])
        torch.cuda.synchronize()
        launches = counts(mods)
    return (logs, lrs, marks, launches, torch.cuda.max_memory_allocated(),
            rec)


def step_checks(torch, trainer, logs, lrs, sched, params0, stats0, marks,
                label, num_pos='num_pos', unreached=()):
    """Of ``recorded_steps``' steps: finite logs on the card, positives
    (the log ``num_pos``, unless None), each step's lr the schedule's,
    every parameter (but ``unreached``) and BN statistic moved; returns
    (step device ms, device ms a step by STEP_STAGES)."""
    model = trainer.model
    for i, (lg, lr) in enumerate(zip(logs, lrs)):
        finite_logs(torch, lg, f'{label} step {i + 1}')
        if not all(v.device.type == DEVICE for v in lg.values()):
            fail(f'{label}: step {i + 1} logs off the card')
        if num_pos is not None and not float(lg[num_pos]) > 0:
            fail(f'{label}: step {i + 1} met no positive')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'{label}: step {i + 1} ran at lr {lr}, the schedule gives '
                 f'{sched(i)}')
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n]) and n not in unreached]
    stuck += [n for n, b in model.named_buffers()
              if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
    if stuck:
        fail(f'{label}: {len(stuck)} tensors did not move: {stuck[:8]}')
    step_ms = [m[0].elapsed_time(m[-1]) for m in marks]
    timed = list(range(1, len(marks))) or [0]
    stages = {k: float(np.mean([marks[i][j].elapsed_time(marks[i][j + 1])
                                for i in timed]))
              for j, k in enumerate(STEP_STAGES)}
    return step_ms, stages


def segmentation_path(torch, mods, card, data, config):
    """One segmentor (``config`` as shipped, f32, seeded random weights)
    on the indoor family's mini ScanNet or the mini S3DIS, at the config's
    B and ``num_points``, the S3DIS configs' 9 channels built here
    (``seg_batch``):

    1. the card's eval forward against the CPU's (``seg_card_vs_cpu``);
    2. main path: SEG_STEPS calls of ``apis.segmentor_train_step`` on the
       resampled scene indices of stage 1, the seg_info label weights as
       class weights (ScanNet's label 20 ignored), the config's optimizer
       through ``build_optimizer`` over its epochs, the counts set to 0
       just before and read just after: no kernel launched, finite
       losses, each step's lr the cyclic schedule's, every parameter and
       BN statistic moved; CUDA events by SEG_STAGES, the FPS share, the
       kNN share, scenes/s, peak memory;
    3. ``apis.infer_segmentor`` over the val split (a random sample of
       each scene's points) and ``seg_eval``: miou, acc and acc_cls finite; ``inference_segmentor``
       on one whole val scene (its first SEG_WHOLE_POINTS points): no
       launch, labels in range."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data import seg_datasets
    from gga_tpu_torch.eval.seg_eval import seg_eval
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.models.segmentors.base import segmentor_draws
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    kind = cfg.model.type
    label = f'{kind} {Path(config).stem}'
    batch, n_points = cfg.data.samples_per_gpu, cfg.data.num_points
    s3dis = cfg.dataset_type == 'S3DISSegDataset'
    d = data['s3dis' if s3dis else 'scannet']
    train_key, val_key = (
        (cfg.data.train_info.split('infos_')[1][:-4],
         cfg.data.val_info.split('infos_')[1][:-4]) if s3dis
        else ('train', 'val'))
    ds_cls = getattr(seg_datasets, cfg.dataset_type)
    train_set = ds_cls(d['root'], d['pkls'][train_key], num_points=n_points)
    # the val scenes sampled as the train split is (test mode takes each
    # scene's first points, which in the mini layouts are floor and walls)
    val_set = ds_cls(d['root'], d['pkls'][val_key], num_points=n_points)
    ignore = None if s3dis else len(ds_cls.CLASSES)
    nine = model_cfg.in_channels == 9
    seg_info = os.path.join(d['root'], 'seg_info')
    idxs = np.load(os.path.join(seg_info,
                                f'{train_key}_resampled_scene_idxs.npy'))
    weights = np.load(os.path.join(seg_info, f'{train_key}_label_weight.npy'))
    spe = len(idxs) // batch
    if spe < SEG_STEPS:
        fail(f'{label}: {len(idxs)} resampled scenes, fewer than '
             f'{SEG_STEPS} steps of B = {batch}')
    total = spe * cfg.max_epochs
    order = np.random.RandomState(0).permutation(len(idxs))
    maxes = seg_scene_max(train_set)
    batches = [seg_batch(train_set, idxs[order[i * batch:(i + 1) * batch]],
                         nine, maxes) for i in range(SEG_STEPS)]
    opt = dict(cfg.optimizer)
    trainer = apis.init_segmentor_trainer(model_cfg, total, device=DEVICE,
                                          seed=0, optimizer=opt)
    model = trainer.model
    print(f'{label}: B = {batch} x {n_points} points x '
          f'{model_cfg.in_channels} channels, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters, '
          f'{spe} steps an epoch, {total} steps in all; class weights '
          f'{[round(float(w), 3) for w in weights]}')
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    res = dict(config=Path(config).name, batch=batch, points=n_points,
               channels=model_cfg.in_channels)

    # --- 1. the card's eval forward against the CPU's --------------------
    res['card_vs_cpu'] = seg_card_vs_cpu(torch, model, kind, batches[0],
                                         label)

    # --- 2. main path -----------------------------------------------------
    sched = cyclic_cos_schedule(opt['lr'], (10, 1e-4), 0.4, total)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    on_card = [{k: torch.as_tensor(v).to(DEVICE) for k, v in b.items()}
               for b in batches]
    keeps = [segmentor_draws(model_cfg, batch, n_points, trainer.generator,
                             DEVICE) for _ in range(SEG_STEPS)]
    with seg_stage_events(torch, model) as spans:
        def step(tr, b, mark):
            spans.append({})
            return apis.segmentor_train_step(tr, b[0], weights, ignore, mark,
                                             b[1])
        logs, lrs, marks, launches, peak, _ = recorded_steps(
            torch, mods, trainer, step, list(zip(on_card, keeps)), label)
    if any(launches.values()):
        fail(f'{label}: {SEG_STEPS} train steps launched {launches}; the '
             'segmentors reach no hand kernel')
    step_ms, _ = step_checks(torch, trainer, logs, lrs, sched, params0,
                             stats0, marks, label, num_pos=None)
    del params0, stats0, on_card, keeps
    timed = list(range(1, SEG_STEPS)) or [0]
    mean_step = float(np.mean([step_ms[i] for i in timed]))
    stages = {k: float(np.mean([seg_stage_ms(spans[i], marks[i])[k]
                                for i in timed]))
              for k in SEG_STAGES + ('FPS',)}
    shares = {k: stages[k] / mean_step for k in stages}
    res.update(steps=SEG_STEPS, step_device_ms=step_ms, stage_ms=stages,
               stage_shares=shares, peak_bytes=peak, launches=launches,
               lrs=lrs, scenes_per_s_events=batch * len(timed) / (
                   sum(step_ms[i] for i in timed) / 1e3),
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {SEG_STEPS} steps at B={batch} (f32): step '
          f'device ms {[round(v, 1) for v in step_ms]}, '
          f'{res["scenes_per_s_events"]:.2f} scenes/s by CUDA events (steps '
          f'{[i + 1 for i in timed]}), FPS {100 * shares["FPS"]:.1f} % and '
          f'the kNN graph {100 * shares["kNN graph"]:.1f} % of a step, peak '
          f'{peak / 2 ** 30:.2f} GiB; launches {launches}; lr {lrs}')
    print(f'{card}: {label}: device ms a step by stage (events, steps '
          f'{[i + 1 for i in timed]}): ' + ', '.join(
              f'{k} {stages[k]:.1f} ({100 * shares[k]:.1f} %)'
              for k in SEG_STAGES))
    print(f'{label}: losses ' + ', '.join(
        f'{k} {[round(lg[k], 4) for lg in res["logs"]]}'
        for k in res['logs'][0]))

    # --- 3. inference -----------------------------------------------------
    bundle = apis.DetectorBundle(model.eval(), model_cfg,
                                 torch.device(DEVICE))
    x = seg_batch(val_set, range(len(val_set)), nine, seg_scene_max(val_set))
    zero_counts(mods)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = apis.infer_segmentor(bundle, x['points'], x['points_valid'])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    if (tuple(pred.shape) != x['seg_labels'].shape
            or pred.device.type != DEVICE):
        fail(f'{label}: infer_segmentor gave {tuple(pred.shape)} on '
             f'{pred.device}')
    pred = pred.cpu().numpy()
    if not ((pred >= 0) & (pred < model_cfg.num_classes)).all():
        fail(f'{label}: labels out of range')
    metrics = seg_eval(list(x['seg_labels']), list(pred),
                       dict(enumerate(ds_cls.CLASSES)),
                       255 if ignore is None else ignore)
    if not all(np.isfinite(metrics[k]) for k in ('miou', 'acc', 'acc_cls')):
        fail(f'{label}: seg_eval gave {metrics}')
    i = 0
    whole = np.fromfile(os.path.join(val_set.root,
                                     val_set.infos[i]['pts_path']),
                        np.float32).reshape(-1, val_set.load_dim)
    if nine:
        whole = np.concatenate([whole, whole[:, :3] / whole[:, :3].max(0)],
                               -1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lab = apis.inference_segmentor(bundle, whole, SEG_WHOLE_POINTS)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t2
    got = counts(mods)
    if any(got.values()):
        fail(f'{label}: inference launched {got}')
    n_whole = min(len(whole), SEG_WHOLE_POINTS)
    if lab.shape != (n_whole,) or not (
            (lab >= 0) & (lab < model_cfg.num_classes)).all():
        fail(f'{label}: inference_segmentor gave {lab.shape}, '
             f'{lab.min()}..{lab.max()}')
    res['infer'] = dict(
        seconds=infer_s, scenes=len(pred), scenes_per_s=len(pred) / infer_s,
        miou=metrics['miou'], acc=metrics['acc'], acc_cls=metrics['acc_cls'],
        whole_points=n_whole, whole_seconds=whole_s,
        whole_points_per_s=n_whole / whole_s, launches=got)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: infer_segmentor on the {len(pred)} val scenes '
          f'{infer_s * 1e3:.1f} ms = {len(pred) / infer_s:.2f} scenes/s (host '
          f'clock), seg_eval miou {metrics["miou"]:.4f} acc '
          f'{metrics["acc"]:.4f} acc_cls {metrics["acc_cls"]:.4f} (random '
          f'weights); inference_segmentor on one whole scene of {n_whole} '
          f'points {whole_s * 1e3:.1f} ms = {n_whole / whole_s:.0f} points/s; '
          f'the path {res["seconds"]:.1f} s')
    del bundle, model, trainer
    torch.cuda.empty_cache()
    return res


def segmentation_phase(torch, mods, card, data, tmp):
    """Stage 1 of a mini S3DIS (``s3dis_stage1``) and each SEG_PATHS
    config (``segmentation_path``) on it or on the indoor family's mini
    ScanNet (``data``, its roots and pkls)."""
    t0 = time.perf_counter()
    data = dict(data, s3dis=s3dis_stage1(card, tmp))
    res = {Path(config).stem: segmentation_path(torch, mods, card, data,
                                                config)
           for config in SEG_PATHS}
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: segmentation phase: {res["seconds"]:.1f} s')
    return res


# --- the image-fusion and image-to-voxel detectors: MVXNet and ImVoxelNet
#     (KITTI and SUN RGB-D) ---------------------------------------------
FU_MVXNET = ('configs/mvxnet/'
             'dv_mvx-fpn_second_secfpn_adamw_2x8_40e_kitti-3d-3class.py')
FU_IMVOXELNET = (
    ('kitti', 'configs/imvoxelnet/imvoxelnet_4x8_kitti-3d-car.py'),
    ('indoor', 'configs/imvoxelnet/imvoxelnet_4x2_sunrgbd-3d-10class.py'))
FU_STEPS = 2                # recorded train steps of each detector
FU_TOL = 1e-4               # card forward against the CPU's, of max|CPU|
# MVXNet's encoder is SECOND's conv_module one at 128 input channels; the
# fused VFE below conv_input carries weights, so conv_input takes an input
# gradient too: one more SubM input gradient than SECOND's
FU_CONVS, FU_DGRAD, FU_STRIDED = SUP_CONVS, SUP_DGRAD + 1, SUP_STRIDED
FU_PER_STEP = dict(gather_gemm_conv=FU_CONVS + FU_DGRAD,
                   gather_gemm_dw=FU_CONVS, gather_rows=FU_STRIDED,
                   gather_rows_t=0, render_heatmap=0)
# mmdet3d's img_norm_cfg of each config: MVXNet's caffe ResNet takes BGR
# less the mean, ImVoxelNet's RGB over the std
FU_IMG_NORM = dict(
    mvxnet=((103.53, 116.28, 123.675), (1.0, 1.0, 1.0), True),
    imvoxelnet=((123.675, 116.28, 103.53), (58.395, 57.12, 57.375), False))
# the mini SUN RGB-D rooms span y in +-2.5 m about the camera, so that
# half their objects stand behind it: ImVoxelNet's batches move each room
# this far forward (+y), into the frustum its prior range covers
FU_ROOM_SHIFT = 2.5
# the biases right before a batch norm (PointFusion's two transforms):
# their gradient is 0 up to rounding, so a step may leave them
FU_PRE_BN_BIASES = ('pts_voxel_encoder.fusion_layer.img_transform.0.bias',
                    'pts_voxel_encoder.fusion_layer.pts_transform.0.bias')


def normalized_image(img, norm):
    """An RGB uint8 image [H, W, 3] -> f32 (less the mean, over the std;
    BGR first where ``norm`` says)."""
    mean, std, bgr = norm
    x = np.asarray(img, np.float32)
    if bgr:
        x = x[..., ::-1]
    return ((x - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32)).astype(np.float32)


def kitti_lidar2img(info):
    """P2 @ R0_rect @ Tr_velo_to_cam of a KITTI info's calib, f32 [4, 4]."""
    c = info['calib']
    return (np.asarray(c['P2'], np.float64) @ np.asarray(c['R0_rect'])
            @ np.asarray(c['Tr_velo_to_cam'])).astype(np.float32)


def fusion_kitti_batches(dataset, root, batch, n, norm, car=False):
    """``n`` batches of the mini KITTI (``KittiDetDataset`` in test mode: no
    point augmentation, which gga_tpu's ``point_sample`` would not undo),
    epoch after epoch, each with its scenes' PNGs (normalized, [B, H, W,
    3]) and lidar2img; ``car``: Car as label 0 (``car_only``)."""
    import os

    from gga_tpu_torch.data.kitti.png import read_png
    out, epoch = [], 0
    while len(out) < n:
        for b in dataset.epoch_batches(batch, seed=epoch):
            infos = [dataset.infos[i] for i in b['sample_idx']]
            b['img'] = np.stack([normalized_image(read_png(os.path.join(
                root, i['image']['image_path'])), norm) for i in infos])
            b['lidar2img'] = np.stack([kitti_lidar2img(i) for i in infos])
            out.append(car_only(b) if car else b)
        epoch += 1
    return out[:n]


def fusion_indoor_batches(dataset, batch, n, norm, seed=0):
    """``n`` batches of the indoor family's mini SUN RGB-D (test mode) with
    a seeded uint8 image of each scene's image shape (its JPEGs hold no
    scan), normalized, and the depth -> image projection of its calib
    (``sunrgbd_depth2img``); the datasets' gravity-centred boxes and the
    points moved FU_ROOM_SHIFT forward."""
    rng = np.random.RandomState(seed)
    out, epoch = [], 0
    while len(out) < n:
        order = np.random.RandomState(epoch).permutation(len(dataset))
        for i in range(0, len(order) // batch * batch, batch):
            idx = order[i:i + batch]
            items = [dataset[j] for j in idx]
            b = {k: np.stack([it[k] for it in items]) for k in items[0]}
            infos = [dataset.infos[j] for j in idx]
            b['img'] = np.stack([normalized_image(rng.randint(
                0, 256, (*i['image']['image_shape'], 3)), norm)
                for i in infos])
            b['lidar2img'] = np.stack([sunrgbd_depth2img(i) for i in infos])
            b['gt_valid'] = b.pop('obj_valid')
            b['points'][..., 1] += FU_ROOM_SHIFT
            b['gt_boxes'][..., 1] += np.where(b['gt_valid'], FU_ROOM_SHIFT,
                                              0.0).astype(np.float32)
            out.append(b)
        epoch += 1
    return out[:n]


def fusion_inputs(torch, kind, batch, device, rows=slice(None)):
    """The detector's forward inputs on ``device`` (images NCHW)."""
    img = torch.as_tensor(batch['img'][rows]).to(device).permute(
        0, 3, 1, 2).contiguous()
    l2i = torch.as_tensor(batch['lidar2img'][rows]).to(device)
    if kind != 'mvxnet':
        return img, l2i
    return (torch.as_tensor(batch['points'][rows]).to(device),
            torch.as_tensor(batch['points_valid'][rows]).to(device), img, l2i)


@contextlib.contextmanager
def leaf_outputs(torch, model, prefixes=None):
    """Record, in call order, (name, output on the CPU) of every leaf
    module of ``model`` (whose name starts with one of ``prefixes``, if
    given) that returns a tensor, a sparse tensor (its features) or a
    tuple that starts with one."""
    out, handles = [], []

    def first_tensor(o):
        o = getattr(o, 'features', o)
        if isinstance(o, (tuple, list)) and o:
            return first_tensor(o[0])
        return o if torch.is_tensor(o) else None

    for name, m in model.named_modules():
        if next(m.children(), None) is None and (
                prefixes is None or name.startswith(tuple(prefixes))):
            def hook(_, __, o, name=name):
                t = first_tensor(o)
                if t is not None and t.dtype.is_floating_point:
                    out.append((name, t.detach().cpu()))
            handles.append(m.register_forward_hook(hook))
    try:
        yield out
    finally:
        for h in handles:
            h.remove()


def module_drift(torch, model, got, ref):
    """Each leaf module's output on the card against the CPU's (the
    ``leaf_outputs`` of one forward each), as max |d| / max|CPU|: the
    first module past FU_TOL / 10 and the three worst, with, for a batch
    norm among them, its smallest running variance and its largest
    |running mean| / sqrt(running variance + eps) (how far it magnifies a
    difference of its input that cancels in the subtraction)."""
    if [n for n, _ in got] != [n for n, _ in ref]:
        return dict(error='the card and the CPU called other modules')
    mods = dict(model.named_modules())
    rows = []
    for i, ((name, g), (_, r)) in enumerate(zip(got, ref)):
        scale = float(r[torch.isfinite(r)].abs().max()) if bool(
            torch.isfinite(r).any()) else 0.0
        d = torch.where(g == r, 0.0, (g - r).abs()).nan_to_num(
            nan=float('inf'))
        row = dict(index=i, module=name, rel=float(d.max()) / max(scale, 1e-30)
                   if r.numel() else 0.0, max_abs_cpu=scale)
        m = mods[name]
        if getattr(m, 'running_var', None) is not None:
            var = m.running_var.detach().float().cpu()
            mean = m.running_mean.detach().float().cpu()
            row.update(min_running_var=float(var.min()), gain=float(
                (mean.abs() / (var + m.eps).sqrt()).max()))
        rows.append(row)
    first = next((r for r in rows if r['rel'] > FU_TOL / 10), None)
    return dict(modules=len(rows), first_past=first,
                worst=sorted(rows, key=lambda r: -r['rel'])[:3])


def fusion_card_vs_cpu(torch, model, kind, batch, label, gate=True,
                       trace=True):
    """The card's eval forward against the same weights' on the CPU, on the
    first scene of ``batch``: every float output within FU_TOL of the
    CPU's largest entry, the projection validity (indoor) equal; with
    ``gate`` False the reading is reported only. ImVoxelHead's face
    distances are ``exp()`` of its ``conv_reg`` logits: the logits are
    compared (``leaf_outputs``), and the distances are reported where both
    sides are finite, beside the largest logit and the worst logit
    difference. With ``trace`` (True, or the name prefixes of the modules
    to trace), ``module_drift`` reports where the difference grows."""
    import copy
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    trace = trace or kind == 'indoor'
    prefixes = None if trace is True else trace
    t0 = time.perf_counter()
    with torch.no_grad():
        with (leaf_outputs(torch, cpu_model, prefixes) if trace
              else contextlib.nullcontext([])) as ref_leaves:
            ref = cpu_model(*fusion_inputs(torch, kind, batch, 'cpu',
                                           slice(1)))
        cpu_s = time.perf_counter() - t0
        with (leaf_outputs(torch, model, prefixes) if trace
              else contextlib.nullcontext([])) as got_leaves:
            got = model(*fusion_inputs(torch, kind, batch, DEVICE, slice(1)))
    res = dict(cpu_forward_s=cpu_s, gated=gate)
    if kind == 'indoor':
        logits = [[t for n, t in leaves if n == 'bbox_head.conv_reg']
                  for leaves in (got_leaves, ref_leaves)]
        dist = [[p['bbox'][..., :6].detach().cpu() for p in out[0]]
                for out in (got, ref)]
        res['distances'] = []
        for g, r, lg, lr in zip(*dist, *logits):
            both = torch.isfinite(g) & torch.isfinite(r)
            res['distances'].append(dict(
                rel_where_finite=float((g - r).abs()[both].max())
                / float(r[both].abs().max()) if bool(both.any())
                else float('nan'),
                share_finite=float(both.float().mean()),
                max_abs_logit=float(lr.abs().max()),
                max_logit_diff=float((lg - lr).abs().max())))
        got, ref = ([[dict(center=p['center'], cls=p['cls'],
                           angle=p['bbox'][..., 6:], reg_logits=lv)
                      for p, lv in zip(out[0], lvs)], out[1]]
                    for out, lvs in zip((got, ref), logits))
    diffs, equal = max_rel_diff(torch, got, ref)
    worst = max(v for v in diffs.values() if not isinstance(v, str))
    res.update(max_rel_diff=worst, diffs=diffs)
    print(f'{label}: eval forward at B = 1, card against CPU (TF32 off): '
          f'max |d| / max|CPU| {worst:.3g} over {len(diffs)} outputs ('
          + (f'gate {FU_TOL}' if gate else f'not gated; the gate elsewhere '
             f'{FU_TOL}') + f'); bool outputs equal: {equal}; the CPU '
          f'forward {cpu_s:.1f} s')
    for i, d in enumerate(res.get('distances', ())):
        print(f'{label}: level {i} face distances (exp of the logits), card '
              f'against CPU where both are finite ({100 * d["share_finite"]:.2f}'
              f' %): max |d| / max|CPU| {d["rel_where_finite"]:.3g} (not '
              f'gated); the largest |logit| {d["max_abs_logit"]:.4g}, the '
              f'worst logit difference {d["max_logit_diff"]:.3g}')
    if trace:
        res['drift'] = module_drift(torch, cpu_model, got_leaves, ref_leaves)
        dr = res['drift']
        print(f'{label}: module drift over {dr.get("modules")} leaf modules: '
              f'first past {FU_TOL / 10:.0e}: {dr.get("first_past")}; worst '
              f'{dr.get("worst")}' if 'error' not in dr else
              f'{label}: module drift: {dr["error"]}')
    del cpu_model, got_leaves, ref_leaves
    if gate and (not equal or not worst <= FU_TOL):
        fail(f'{label}: card forward against the CPU: {diffs}')
    return res


def mvxnet_path(torch, mods, card, tmp):
    """MVXNet (FU_MVXNET as shipped, f32, seeded random weights) on the
    workflow's mini KITTI (its 16 trainval scenes' reduced clouds, up to
    ``data.max_points`` points, the rendered 375 x 1242 PNGs, lidar2img
    from each calib) at the config's B = 2:

    1. the card's eval forward against the CPU's (``fusion_card_vs_cpu``),
       gated; then, reported, the same on a copy whose BN statistics
       ``calibrate_bn`` set to the first train batch's;
    2. one whole step with kernels against plain, cuDNN off, on the
       initial weights (``step_comparison``: f32 gates);
    3. main path: FU_STEPS calls of ``apis.mvxnet_train_step`` on the
       config's optimizer block through ``build_optimizer`` over its
       epochs, the counts set to 0 just before and read just after:
       exactly FU_PER_STEP launches a step, every one of them f32 (the
       recorded calls by the features' dtype); finite losses with
       positives, each step's lr the cyclic schedule's, every parameter
       (but the two pre-BN biases) and BN statistic moved; CUDA events by
       stage, peak memory, the encoder's budget occupancy (reported); then
       the first step's recorded kernel calls replayed
       against their plain versions (conv f32 1e-5, dW 2e-5 and the same
       bits twice, gathers exact on a cold L2) and a profile of one more
       step (the share of cuDNN's FFT plan);
    4. after ``calibrate_bn`` on the val batch, the card's eval forward
       against the CPU's again (reported, with where the difference
       grows), ``infer_mvxnet`` on the 8 val scenes (FU_CONVS launches a
       forward, the kept boxes finite) and
       ``inference_multi_modality_detector`` on one of them."""
    import copy
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.models.layers import SparseConvBlock
    from gga_tpu_torch.train import loop
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    sparse_conv, gr, _ = mods
    t0 = time.perf_counter()
    data = os.path.join(tmp, 'kitti')
    cfg = Config.fromfile(str(ROOT / FU_MVXNET))
    model_cfg = build_detector(cfg)[1]
    d = cfg.data
    B = d.samples_per_gpu
    label = f'MVXNet {Path(FU_MVXNET).stem}'

    def dataset(info):
        return KittiDetDataset(data, os.path.join(data, info),
                               pc_range=cfg.point_cloud_range,
                               pts_prefix=d.pts_prefix,
                               max_points=d.max_points, test_mode=True)
    train_set = dataset(SUP_INFO)
    spe = len(train_set) // B
    total = spe * cfg.max_epochs
    norm = FU_IMG_NORM['mvxnet']
    batches = fusion_kitti_batches(train_set, data, B, FU_STEPS, norm)
    opt = dict(cfg.optimizer)
    trainer = apis.init_mvxnet_trainer(model_cfg, total, device=DEVICE,
                                       seed=0, optimizer=opt)
    model = trainer.model
    print(f'{label}: B = {B} x up to {d.max_points} points and '
          f'{batches[0]["img"].shape[1:3]} images, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters, {spe} '
          f'steps an epoch, {total} steps in all')
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    res = dict(config=Path(FU_MVXNET).name, batch=B, points=d.max_points)

    # --- 1. the card's eval forward against the CPU's --------------------
    res['card_vs_cpu'] = fusion_card_vs_cpu(torch, model, 'mvxnet',
                                            batches[0], label)
    # the same on a copy at the statistics of the first train batch (2
    # scenes; the main path starts from the initial ones): reported
    twin = calibrate_bn(torch, copy.deepcopy(model), batches[0],
                        lambda m, b: m(*fusion_inputs(torch, 'mvxnet', b,
                                                      DEVICE)))
    res['card_vs_cpu_train_stats'] = fusion_card_vs_cpu(
        torch, twin, 'mvxnet', batches[0],
        f'{label} (statistics of the first train batch)', gate=False)
    del twin

    # --- 2. one whole step with kernels against plain ---------------------
    def as_model_batch(b):
        pts, val, img, l2i = fusion_inputs(torch, 'mvxnet', b, DEVICE)
        return dict(points=pts, points_valid=val, img=img, lidar2img=l2i,
                    **{k: torch.as_tensor(b[k]).to(DEVICE)
                       for k in ('gt_boxes', 'gt_labels', 'gt_valid')})

    cmp_step = step_comparison(
        torch, mods, trainer, as_model_batch(batches[0]),
        lambda m, b: loop.mvxnet_loss(m, b)[0], FU_CONVS)
    print_step_comparison(f'{label} whole step kernels vs plain', cmp_step)
    res['step_comparison'] = cmp_step

    # --- 3. main path -----------------------------------------------------
    on_card = [{k: torch.as_tensor(v).to(DEVICE) for k, v in b.items()}
               for b in batches]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    diags, sites = [], []

    def step(tr, b, mark):
        diags.append({})
        sites.append({})
        return apis.mvxnet_train_step(tr, b, mark, diags[-1])

    # the active sites a scene after each strided conv and conv_out, over
    # its budget (the largest scene's)
    hooks = [blk.register_forward_hook(
        lambda blk, _, st, name=name: sites[-1].__setitem__(
            name, st.valid.sum(-1).max() / blk[0].out_budget))
        for name, blk in model.pts_middle_encoder.named_modules()
        if isinstance(blk, SparseConvBlock)]
    try:
        logs, lrs, marks, launches, peak, rec = recorded_steps(
            torch, mods, trainer, step, on_card, label,
            record=((sparse_conv, 'gather_gemm_conv'),
                    (sparse_conv, 'gather_gemm_dw'), (gr, 'gather_rows')))
    finally:
        for h in hooks:
            h.remove()
    want = {k: v * FU_STEPS for k, v in FU_PER_STEP.items()}
    if launches != want:
        fail(f'{label}: {FU_STEPS} steps launched {launches}, expected '
             f'{want}')
    # each recorded call is one launch; the launches by the dtype of the
    # features (the f32 and bf16 entries of one wrapper)
    by_dtype = {k: {str(dt).replace('torch.', ''): sum(
        a[0].dtype == dt for _, a in v) for dt in (torch.float32,
                                                    torch.bfloat16)}
        for k, v in rec.items()}
    if (any(sum(v.values()) != launches[k] for k, v in by_dtype.items())
            or any(v['bfloat16'] for v in by_dtype.values())):
        fail(f'{label}: launches by dtype {by_dtype}, counted {launches}: '
             'the f32 config launched other than f32 kernels')
    occupancy = dict(
        out_mean=[float(d['occupancy_out']) for d in diags],
        largest_scene=[{k: float(v) for k, v in s_.items()} for s_ in sites])
    sched = cyclic_cos_schedule(opt['lr'], (10, 1e-4), 0.4, total)
    step_ms, stages = step_checks(
        torch, trainer, logs, lrs, sched, params0, stats0, marks, label,
        unreached=FU_PRE_BN_BIASES)
    del params0, stats0
    res.update(steps=FU_STEPS, launches=launches, step_device_ms=step_ms,
               launches_by_dtype=by_dtype, occupancy=occupancy,
               stage_ms=stages, peak_bytes=peak, lrs=lrs,
               scenes_per_s_events=B * max(len(step_ms) - 1, 1) / (
                   sum(step_ms[1:] or step_ms) / 1e3),
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {FU_STEPS} steps at B={B} (f32): step device '
          f'ms {[round(v, 1) for v in step_ms]}; by stage (mean after the '
          'first) ' + ', '.join(f'{k} {v:.1f}' for k, v in stages.items())
          + f'; peak {peak / 2 ** 30:.2f} GiB; launches {launches}, by '
          f'dtype {by_dtype}; lr {lrs}; losses '
          f'{[round(lg["loss"], 4) for lg in res["logs"]]}, num_pos '
          f'{[lg["num_pos"] for lg in res["logs"]]}')
    print(f'{label}: encoder budgets: occupancy_out (mean a scene, as '
          f'gga_tpu sows it) {occupancy["out_mean"]}; the largest scene\'s '
          f'active sites over the budget of each strided conv and conv_out '
          f'{occupancy["largest_scene"]} (1.0: saturated)')
    first = {k: v[:FU_PER_STEP[k]] for k, v in rec.items()}
    del rec
    torch.set_grad_enabled(False)
    conv_rows, dwr, _ = train_kernel_rows(torch, sparse_conv, first,
                                          f'{label} kernels', FU_CONVS,
                                          FU_DGRAD)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=DEVICE)
    gr_rows = rows_rows(torch, gr, [a for _, a in first['gather_rows']],
                        False, f'{label} kernels', flush)
    del flush, first
    torch.set_grad_enabled(True)
    res['profile'] = device_profile(
        torch, lambda: apis.mvxnet_train_step(trainer, on_card[0]))
    print_profile(f'{label} train step', res['profile'])
    print(f'{card}: {label}: cuDNN\'s FFT plan (FFT and complex GEMM '
          f'kernels) {res["profile"]["fft_ms"]:.2f} ms of the profiled '
          f'step\'s {res["profile"]["busy_ms"]:.2f} device ms')
    del on_card
    torch.cuda.empty_cache()

    # --- 4. inference -----------------------------------------------------
    val_set = dataset(SUP_VAL_INFO)
    vb = fusion_kitti_batches(val_set, data, len(val_set), 1, norm)[0]
    calibrate_bn(torch, model, vb, lambda m, b: m(*fusion_inputs(
        torch, 'mvxnet', b, DEVICE)))
    res['card_vs_cpu_calibrated'] = fusion_card_vs_cpu(
        torch, model, 'mvxnet', vb, f'{label} (calibrated)', gate=False)
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    zero_counts(mods)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = apis.infer_mvxnet(bundle, vb['points'], vb['points_valid'],
                            vb['img'], vb['lidar2img'])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    got = counts(mods)
    n = len(val_set)
    if (got != dict(dict.fromkeys(FU_PER_STEP, 0), gather_gemm_conv=FU_CONVS)
            or tuple(out['boxes'].shape[:1]) != (n,)
            or out['boxes'].shape[-1] != 7
            or not torch.isfinite(out['boxes'][out['valid']]).all()):
        fail(f'{label}: infer_mvxnet on {n} scenes launched {got}, boxes '
             f'{tuple(out["boxes"].shape)}')
    m = int(vb['points_valid'][0].sum())
    zero_counts(mods)
    t2 = time.perf_counter()
    one = apis.inference_multi_modality_detector(
        bundle, vb['points'][0, :m], vb['img'][0], vb['lidar2img'][0],
        max_points=d.max_points)
    one_s = time.perf_counter() - t2
    got1 = counts(mods)
    if (got1['gather_gemm_conv'] != FU_CONVS
            or one['boxes_3d'].shape[1:] != (7,)
            or not np.isfinite(one['boxes_3d']).all()):
        fail(f'{label}: inference_multi_modality_detector launched {got1}, '
             f'boxes {one["boxes_3d"].shape}')
    res['infer'] = dict(scenes=n, seconds=infer_s, scenes_per_s=n / infer_s,
                        kept=int(out['valid'].sum()), launches=got,
                        single_seconds=one_s, single_kept=len(one['scores_3d']),
                        single_launches=got1)
    res.update(conv_calls=conv_rows, dw_calls=dwr, gather_rows=gr_rows,
               seconds=time.perf_counter() - t0)
    print(f'{card}: {label}: infer_mvxnet on the {n} val scenes in one batch '
          f'{infer_s * 1e3:.1f} ms (host clock), {res["infer"]["kept"]} kept '
          f'boxes, launches {got}; inference_multi_modality_detector on one '
          f'scene of {m} points {one_s * 1e3:.1f} ms, '
          f'{len(one["scores_3d"])} boxes; the path {res["seconds"]:.1f} s')
    del bundle, model, trainer
    torch.cuda.empty_cache()
    return res


def imvoxelnet_path(torch, mods, card, tmp, data, kind, config):
    """ImVoxelNet (``kind`` 'kitti': the car config on the workflow's mini
    KITTI, Car as label 0; 'indoor': the SUN RGB-D config on the indoor
    family's mini SUN RGB-D, ``data``), as shipped, f32, seeded random
    weights, at the config's B:

    1. the card's eval forward against the CPU's (``fusion_card_vs_cpu``);
    2. main path: FU_STEPS calls of ``apis.imvoxelnet_train_step`` on the
       configs' optimizer block (AdamW, the lr down at epochs 8 and 11),
       the counts set to 0 just before and read just after: no launch of
       any wrapper; finite losses with positives, each step's lr the
       schedule's, every parameter and BN statistic moved but the FPN
       levels the lift does not sample (and the indoor head's scale of a
       level no positive landed on); CUDA events by stage, peak memory;
    3. after ``calibrate_bn`` on a batch, the card's eval forward against
       the CPU's again (reported), then ``apis.infer_imvoxelnet`` on the
       batch: no launch, boxes [B, n, 7], the kept ones finite."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.data.sunrgbd import SunRgbdDataset
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    B = cfg.data.samples_per_gpu
    label = f'ImVoxelNet {Path(config).stem}'
    norm = FU_IMG_NORM['imvoxelnet']
    if kind == 'kitti':
        root = os.path.join(tmp, 'kitti')
        d = cfg.data
        ds = KittiDetDataset(root, os.path.join(root, SUP_INFO),
                             pc_range=cfg.point_cloud_range,
                             pts_prefix=d.pts_prefix, max_points=d.max_points,
                             test_mode=True)
        batches = fusion_kitti_batches(ds, root, B, FU_STEPS + 1, norm,
                                       car=True)
    else:
        ds = SunRgbdDataset(data['sunrgbd']['root'],
                            data['sunrgbd']['pkls']['train'], test_mode=True)
        batches = fusion_indoor_batches(ds, B, FU_STEPS + 1, norm)
    spe = len(ds) // B
    if not spe:
        fail(f'{label}: {len(ds)} scenes, fewer than B = {B}')
    opt = dict(cfg.optimizer)
    trainer = apis.init_imvoxelnet_trainer(model_cfg, spe, device=DEVICE,
                                           seed=0, optimizer=opt)
    model = trainer.model
    print(f'{label}: B = {B} x {batches[0]["img"].shape[1:3]} images, '
          f'{model_cfg.n_voxels} voxels, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters, {spe} '
          'steps an epoch')
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    res = dict(config=Path(config).name, batch=B,
               image=list(batches[0]['img'].shape[1:3]))

    # --- 1. the card's eval forward against the CPU's --------------------
    # (the KITTI neck's volumes take GBs a module: its trace covers the
    # image backbone and FPN only)
    trace = True if kind == 'indoor' else ('backbone.', 'neck.')
    res['card_vs_cpu'] = fusion_card_vs_cpu(torch, model, kind, batches[0],
                                            label, trace=trace)

    # --- 2. main path -----------------------------------------------------
    on_card = [{k: torch.as_tensor(v).to(DEVICE) for k, v in b.items()}
               for b in batches]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    logs, lrs, marks, launches, peak, _ = recorded_steps(
        torch, mods, trainer, apis.imvoxelnet_train_step,
        on_card[:FU_STEPS], label)
    if any(launches.values()):
        fail(f'{label}: {FU_STEPS} train steps launched {launches}; '
             'ImVoxelNet reaches no hand kernel')
    sched = piecewise_constant_schedule(
        opt['lr'], {spe * e: opt['lr_gamma'] for e in opt['lr_steps']})
    # the lift samples FPN level 0: no gradient reaches levels 1-3's
    # output convs, nor the extra level's; and a level of the indoor head
    # that no positive of the last step landed on takes no gradient in its
    # scale
    unreached = tuple(n for n, p in model.named_parameters()
                      if (n.startswith('neck.fpn_convs.')
                          and not n.startswith('neck.fpn_convs.0.'))
                      or (n.startswith('bbox_head.scales.')
                          and not bool(p.grad.abs().sum() > 0)))
    step_ms, stages = step_checks(
        torch, trainer, logs, lrs, sched, params0, stats0, marks, label,
        unreached=unreached)
    del params0, stats0
    res.update(steps=FU_STEPS, launches=launches, step_device_ms=step_ms,
               stage_ms=stages, peak_bytes=peak, lrs=lrs,
               scenes_per_s_events=B * max(len(step_ms) - 1, 1) / (
                   sum(step_ms[1:] or step_ms) / 1e3),
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {FU_STEPS} steps at B={B} (f32): step device '
          f'ms {[round(v, 1) for v in step_ms]}; by stage (mean after the '
          'first) ' + ', '.join(f'{k} {v:.1f}' for k, v in stages.items())
          + f'; peak {peak / 2 ** 30:.2f} GiB; launches {launches}; lr '
          f'{lrs}; losses {[round(lg["loss"], 4) for lg in res["logs"]]}, '
          f'num_pos {[lg["num_pos"] for lg in res["logs"]]}')

    # --- 3. inference -----------------------------------------------------
    b = on_card[FU_STEPS]
    calibrate_bn(torch, model, b, lambda m, b_: m(b_['img'].permute(
        0, 3, 1, 2).contiguous(), b_['lidar2img']))
    res['card_vs_cpu_calibrated'] = fusion_card_vs_cpu(
        torch, model, kind, batches[FU_STEPS], f'{label} (calibrated)',
        gate=False, trace=trace)
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    zero_counts(mods)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = apis.infer_imvoxelnet(bundle, b['img'], b['lidar2img'])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    got = counts(mods)
    if (any(got.values()) or out['boxes'].shape[0] != B
            or out['boxes'].shape[-1] != 7
            or not torch.isfinite(out['boxes'][out['valid']]).all()):
        fail(f'{label}: infer_imvoxelnet launched {got}, boxes '
             f'{tuple(out["boxes"].shape)}')
    res['infer'] = dict(scenes=B, seconds=infer_s, scenes_per_s=B / infer_s,
                        kept=int(out['valid'].sum()), launches=got)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: infer_imvoxelnet on {B} scenes '
          f'{infer_s * 1e3:.1f} ms (host clock), {res["infer"]["kept"]} kept '
          f'boxes of {tuple(out["boxes"].shape)}; the path '
          f'{res["seconds"]:.1f} s')
    del bundle, model, trainer, on_card
    torch.cuda.empty_cache()
    return res


def fusion_phase(torch, mods, card, tmp, data):
    """MVXNet (``mvxnet_path``) and both ImVoxelNet configs
    (``imvoxelnet_path``) on the workflow's mini KITTI and the indoor
    family's mini SUN RGB-D (``data``)."""
    t0 = time.perf_counter()
    res = dict(mvxnet=mvxnet_path(torch, mods, card, tmp))
    for kind, config in FU_IMVOXELNET:
        res[f'imvoxelnet_{kind}'] = imvoxelnet_path(torch, mods, card, tmp,
                                                    data, kind, config)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: fusion phase: {res["seconds"]:.1f} s')
    return res


# --- the accuracy benches: weak GGA training to pseudo-label AP, then the
#     PGD retrain on those pseudo labels ----------------------------------
ACC_SCENES = 16             # synthetic scenes (make_synth_kitti, seed 0)
ACC_BATCH = 8               # 2 steps an epoch
# weak-train steps of the CLI, and its evals (400 and 200 through PR 20,
# cut to keep the whole script inside its time limit on a slow host)
ACC_STEPS = 200
ACC_EVAL_EVERY = 100
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
          f'{cmp_step["bn_update_max_rel_err"]:.3g} of their largest entry; '
          'ReLU and scatter-max units the kernel step\'s branches '
          'overrode: plain '
          f'{cmp_step["relu_flips_plain"]}, one ulp of noise '
          f'{cmp_step["relu_flips_plain_ulp_noise"]}, reordered '
          f'{cmp_step["relu_flips_plain_reordered"]} of '
          f'{cmp_step["relu_units"]}')


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


# --- data parallel: the sharded stage 3 and the two-rank GGA step ----------

DP_WORLD = 2
DP_STEPS = 3                # train steps a rank, after the comparison
DP_SEED = 10                # the comparison's batch; the steps' follow it
DP_AR_REPS = 5              # timed all-reduces of the step's gradients
DP_TOL = 1e-4               # loss, boxes and scores, batch-norm statistics


def dp_kernel_modules():
    """The kernel modules of the path, in a spawned process (which
    imports this file anew, without ``main``'s path)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from gga_tpu_torch.kernels import gather_rows as gr
    from gga_tpu_torch.kernels import heatmap, sparse_conv
    return sparse_conv, gr, heatmap


def dp_sync(torch, dev):
    if str(dev).startswith('cuda'):
        torch.cuda.synchronize()


def dp_stage3_rank(rank, world, argv, out):
    """One process of the sharded stage-3 CLI (``--rank`` / ``--world``,
    no process group): its summary and launches to ``out``."""
    mods = dp_kernel_modules()
    from gga_tpu_torch.tools import generate_pseudo_labels_gga as stage3
    zero_counts(mods)
    res = stage3.main(argv + ['--rank', str(rank), '--world', str(world)])
    res['launches'] = counts(mods)
    with open(Path(out) / f'stage3_rank{rank}.json', 'w') as f:
        json.dump(res, f, default=str)


def pseudo_pkl_diff(got, want):
    """(mismatches, the largest difference of each float field) of two
    pseudo-info lists: the scenes in order, the box count and names a
    scene, and boxes and scores within ``DP_TOL``."""
    bad, worst = [], {}
    if [i['image']['image_idx'] for i in got] != [
            i['image']['image_idx'] for i in want]:
        return ['scene order'], worst
    for g, w in zip(got, want):
        ga, wa = g['annos'], w['annos']
        idx = w['image']['image_idx']
        if len(ga['name']) != len(wa['name']) or list(ga['name']) != list(
                wa['name']):
            bad.append(f'scene {idx}: {len(ga["name"])} boxes vs '
                       f'{len(wa["name"])}')
            continue
        for k, v in wa.items():
            v = np.asarray(v)
            if v.dtype.kind != 'f' or not v.size:
                continue
            d = float(np.abs(np.asarray(ga[k], np.float64) - v).max())
            worst[k] = max(worst.get(k, 0.0), d)
            if k in ('location', 'dimensions', 'rotation_y', 'score') \
                    and not d <= DP_TOL:
                bad.append(f'scene {idx}: {k} differs by {d}')
    return bad, worst


def dp_stage3(torch, apis, mods, card, tmp):
    """(a): the stage-3 CLI as two processes against one process."""
    import pickle

    from gga_tpu_torch.config import Config
    from gga_tpu_torch.tools import generate_pseudo_labels_gga as stage3
    from gga_tpu_torch.tools_lib import model_config_from_cfg
    from gga_tpu_torch.train import checkpoints as ckpt

    work = Path(tmp) / 'data_parallel'
    opts = ['--cfg-options', f'data_root={Path(tmp) / "kitti"}/',
            *WF_OPTIONS]
    cfg = Config.fromfile(str(ROOT / WF_MATCHING)).merge_from_options(
        dict(kv.split('=', 1) for kv in opts[1:]))
    ckpt_dir = str(work / 'checkpoints')
    ckpt.save_checkpoint(ckpt_dir, apis.init_trainer(
        model_config_from_cfg(cfg), 10, device=DEVICE,
        seed=cfg.get('seed', 0)))
    torch.cuda.empty_cache()
    argv = [str(ROOT / WF_MATCHING), '--checkpoint', ckpt_dir, '--device',
            DEVICE, *opts]
    zero_counts(mods)
    one = stage3.main(argv + ['--out', str(work / 'pseudo_one.pkl')])
    one['launches'] = counts(mods)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(
        dp_stage3_rank, args=(DP_WORLD, argv + [
            '--out', str(work / 'pseudo_ranks.pkl'), '--tmpdir',
            str(work / 'parts')], str(work)), nprocs=DP_WORLD, join=True)
    wall_s = time.perf_counter() - t0
    ranks = []
    for r in range(DP_WORLD):
        with open(work / f'stage3_rank{r}.json') as f:
            ranks.append(json.load(f))
    n = one['infos']
    batch = cfg.data.samples_per_gpu
    for r, res in enumerate(ranks):
        scenes = len(range(r, n, DP_WORLD))
        want = dict(gather_gemm_conv=N_CONVS * -(-scenes // batch),
                    gather_gemm_dw=0, gather_rows=0, gather_rows_t=0,
                    render_heatmap=0)
        if res['launches'] != want:
            fail(f'data parallel: stage-3 rank {r} launches '
                 f'{res["launches"]}, expected {want}')
    if ranks[0].get('infos') != n or ranks[1].get('scenes') != n // 2:
        fail(f'data parallel: stage-3 ranks report {ranks}, expected {n} '
             'merged scenes')
    with open(work / 'pseudo_one.pkl', 'rb') as f:
        want = pickle.load(f)
    with open(work / 'pseudo_ranks.pkl', 'rb') as f:
        got = pickle.load(f)
    bad, worst = pseudo_pkl_diff(got, want)
    if bad:
        fail(f'data parallel: the merged pseudo pkl differs from one '
             f'process\'s: {bad[:5]}')
    boxes = sum(len(i['annos']['name']) for i in want)
    print(f'{card}: data parallel (a) stage-3 CLI as {DP_WORLD} processes '
          f'on one card: {n} scenes in {wall_s:.2f} s of wall time, spawn '
          f'included (one process: {one["seconds"]:.2f} s load through '
          f'matching); rank 0 merged the one-process pkl\'s {n} scenes in '
          f'its order, {boxes} boxes, the same count a scene; largest '
          'differences: ' + ', '.join(f'{k} {v:.3g}'
                                      for k, v in sorted(worst.items()))
          + f'; launches a rank {[r["launches"] for r in ranks]}')
    return dict(scenes=n, boxes=boxes, wall_s=wall_s, one=one, ranks=ranks,
                max_diff=worst)


def dp_batch(torch, spec, seed):
    """One global train batch of ``spec``'s size on its device."""
    return {k: torch.from_numpy(v).to(spec['device'])
            for k, v in make_batch(spec['B'], spec['P'], spec['M'],
                                   spec['PC'], seed).items()}


def dp_srl(torch, spec):
    """The SRL prior's normal draw of the comparison's global batch."""
    return torch.randn((len(spec['tcfg'].head.task_num_classes), spec['B']),
                       generator=torch.Generator().manual_seed(5)).to(
                           spec['device'])


def dp_reference(torch, apis, spec):
    """(b), one process: the comparison's loss, sparse conv weight
    gradients (float64, on the host), the batch-norm statistics after the
    forward, the same gradients under one ulp of input noise, and the
    wall ms of a train step after a warm-up one."""
    dev = spec['device']
    trainer = apis.init_trainer(spec['tcfg'], total_steps=10000, device=dev,
                                seed=0)
    batch = dp_batch(torch, spec, DP_SEED)
    srl = dp_srl(torch, spec)

    def loss_fn(model, b):
        return gga_loss(model, b, srl)

    stats0 = {n: b.clone() for n, b in trainer.model.named_buffers()}
    with torch.backends.cudnn.flags(enabled=False):
        loss, _, grads, moves = loss_and_grads(torch, trainer, batch,
                                               loss_fn)
        with input_ulp_noise(torch, trainer.model):
            _, _, noisy, _ = loss_and_grads(torch, trainer, batch, loss_fn)
    res = dict(loss=loss,
               grads={n: g.double().cpu() for n, g in grads.items()},
               noisy={n: g.double().cpu() for n, g in noisy.items()},
               stats={n: (stats0[n] + m).cpu() for n, m in moves.items()})
    ms = []
    for _ in range(2):
        dp_sync(torch, dev)
        t0 = time.perf_counter()
        apis.train_step(trainer, batch)
        dp_sync(torch, dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    res['step_ms'] = ms[-1]
    return res


def dp_train_rank(rank, world, spec):
    """(b), one rank of a gloo group of ``world`` on ``spec['device']``:
    the comparison's loss and gradients summed over the ranks before the
    clip, then ``DP_STEPS`` train steps with the counts set to 0 just
    before them and read just after; its numbers to ``spec['out']``."""
    mods = dp_kernel_modules()
    import torch
    from gga_tpu_torch import apis
    from gga_tpu_torch.parallel import mesh

    dev = spec['device']
    if dev.startswith('cuda'):
        torch.cuda.set_device(torch.device(dev).index or 0)
    mesh.init_distributed(spec['url'], world, rank, 'gloo')
    try:
        res = dp_train(torch, apis, mesh, mods, rank, world, spec)
    finally:
        mesh.shutdown()
    torch.save(res, Path(spec['out']) / f'train_rank{rank}.pt')


def dp_train(torch, apis, mesh, mods, rank, world, spec):
    dev = spec['device']
    b = spec['B'] // world
    trainer = apis.init_trainer(spec['tcfg'], total_steps=10000, device=dev,
                                seed=0)
    params = trainer.optimizer.params
    batches = [mesh.shard_rows(dp_batch(torch, spec, DP_SEED + i), rank,
                               world) for i in range(DP_STEPS + 1)]
    srl = dp_srl(torch, spec)[:, rank * b:(rank + 1) * b]
    stats0 = {n: t.clone() for n, t in trainer.model.named_buffers()}
    with torch.backends.cudnn.flags(enabled=False):
        loss, _, grads, moves = loss_and_grads(
            torch, trainer, batches[0], lambda m, bt: gga_loss(m, bt, srl),
            after_backward=lambda: mesh.all_reduce_grads(params))
    loss = float(mesh.sum_over_ranks([torch.tensor(loss, device=dev)])[0])
    res = dict(loss=loss, grads={n: g.double().cpu()
                                 for n, g in grads.items()},
               stats={n: (stats0[n] + m).cpu() for n, m in moves.items()})
    if dev.startswith('cuda'):
        torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    dp_sync(torch, dev)
    zero_counts(mods)
    for batch in batches[1:]:
        t0 = time.perf_counter()
        logs = apis.train_step(trainer, batch)
        dp_sync(torch, dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs['loss']))
    res.update(launches=counts(mods), step_ms=step_ms, losses=losses,
               peak_bytes=(torch.cuda.max_memory_allocated()
                           if dev.startswith('cuda') else None))
    # one more step with every all-reduce counted and timed by the host
    # clock between synchronizes: the share of a step they take
    real, calls = torch.distributed.all_reduce, []

    def timed(t, *args, **kwargs):
        dp_sync(torch, dev)
        t0 = time.perf_counter()
        out = real(t, *args, **kwargs)
        dp_sync(torch, dev)
        calls.append(((time.perf_counter() - t0) * 1e3,
                      t.numel() * t.element_size()))
        return out

    torch.distributed.all_reduce = timed
    try:
        t0 = time.perf_counter()
        apis.train_step(trainer, batches[1])
        dp_sync(torch, dev)
        res['counted_step_ms'] = (time.perf_counter() - t0) * 1e3
    finally:
        torch.distributed.all_reduce = real
    res.update(all_reduces=len(calls),
               all_reduce_ms_sum=sum(ms for ms, _ in calls),
               all_reduce_bytes_sum=sum(n for _, n in calls))
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    lead = flat.clone()
    torch.distributed.broadcast(lead, 0)
    res['weights_equal_rank0'] = bool(torch.equal(flat, lead))
    ar = []
    for _ in range(DP_AR_REPS):
        dp_sync(torch, dev)
        t0 = time.perf_counter()
        mesh.all_reduce_grads(params)
        dp_sync(torch, dev)
        ar.append((time.perf_counter() - t0) * 1e3)
    res.update(allreduce_ms=ar, allreduce_bytes=4 * (
        len(params) + sum(p.numel() for p in params)))
    return res


def cosine64(a, b):
    return float((a * b).sum() / (a.norm() * b.norm()).clamp(min=1e-300))


def dp_step(torch, apis, card, tmp):
    """(b): the full-width f32 GGA step at two gloo ranks against one
    process."""
    _, tcfg = configs('float32')
    spec = dict(tcfg=tcfg, device=DEVICE, B=B, P=P, M=M_OBJ, PC=PC,
                out=str(Path(tmp) / 'data_parallel'),
                url=f'file://{Path(tmp) / "data_parallel" / "store"}')
    Path(spec['out']).mkdir(exist_ok=True)
    one = dp_reference(torch, apis, spec)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(dp_train_rank, args=(DP_WORLD, spec),
                                nprocs=DP_WORLD, join=True)
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(Path(spec['out']) / f'train_rank{r}.pt',
                        weights_only=False) for r in range(DP_WORLD)]
    loss_rel = abs(ranks[0]['loss'] - one['loss']) / abs(one['loss'])
    if not (np.isfinite(ranks[0]['loss']) and loss_rel <= DP_TOL):
        fail(f'data parallel: two-rank loss {ranks[0]["loss"]} vs one '
             f'process {one["loss"]}')
    gate = GATES['float32']
    cos, cos_noise = {}, {}
    for name, g in one['grads'].items():
        cos_noise[name] = cosine64(g, one['noisy'][name])
        for r in ranks:
            c = cosine64(r['grads'][name], g)
            cos[name] = min(c, cos.get(name, 1.0))
        c = cos[name]
        if not (c >= gate['cos_min'] or (
                c >= gate['cos_floor']
                and 1 - c <= 2 * (1 - cos_noise[name]))):
            fail(f'data parallel: {name} weight gradient cosine {c} < '
                 f'{gate["cos_min"]} and beyond twice the one-process '
                 f'step\'s one-ulp noise (cosine {cos_noise[name]}) or '
                 f'{gate["cos_floor"]}')
    if len(cos) != N_CONVS:
        fail(f'data parallel: {len(cos)} sparse conv weight gradients, '
             f'expected {N_CONVS}')
    # each running statistic's largest |rank - one| over its bound
    # (DP_TOL of |one| plus 1e-5); <= 1 passes
    stat_err = 0.0
    for name, want in one['stats'].items():
        for r in ranks:
            ratio = float(((r['stats'][name] - want).abs()
                           / (DP_TOL * want.abs() + 1e-5)).max())
            stat_err = max(stat_err, ratio)
            if not ratio <= 1.0:
                fail(f'data parallel: batch-norm statistic {name} differs '
                     f'from one process\'s by {ratio} of {DP_TOL} '
                     'relative plus 1e-5')
    for r, res in enumerate(ranks):
        want = {k: v * DP_STEPS for k, v in PER_STEP.items()}
        got = {k: res['launches'][k] for k in want}
        if got != want or res['launches']['gather_rows_t']:
            fail(f'data parallel: rank {r} launches {res["launches"]} in '
                 f'{DP_STEPS} steps, expected {want}')
        if not res['weights_equal_rank0']:
            fail(f'data parallel: rank {r}\'s weights differ from rank 0\'s '
                 f'after {DP_STEPS} steps')
        if not all(np.isfinite(res['losses'])):
            fail(f'data parallel: rank {r} losses {res["losses"]}')
    step_ms = [float(np.mean(r['step_ms'][1:])) for r in ranks]
    ar_ms = [float(np.mean(r['allreduce_ms'])) for r in ranks]
    peak = [r['peak_bytes'] for r in ranks]
    print(f'{card}: data parallel (b) GGA step, f32, {DP_WORLD} gloo ranks x '
          f'{B // DP_WORLD} scenes vs one process x {B}: loss '
          f'{ranks[0]["loss"]:.8g} vs {one["loss"]:.8g} (rel {loss_rel:.3g});'
          f' min cosine of the {len(cos)} sparse conv weight gradients '
          f'{min(cos.values()):.8f} (one process, one ulp of input noise: '
          f'{min(cos_noise.values()):.8f}); batch-norm statistics within '
          f'{stat_err:.3g} of their bound; launches a rank '
          f'{ranks[0]["launches"]} in {DP_STEPS} steps; weights equal on '
          'both ranks')
    print(f'{card}: data parallel (b) per-rank step ms (after the first) '
          f'{[round(v, 2) for v in step_ms]} vs one process x {B} '
          f'{one["step_ms"]:.2f}; gradient all-reduce '
          f'({ranks[0]["allreduce_bytes"] / 2 ** 20:.1f} MiB, gloo through '
          f'the host) ms {[round(v, 2) for v in ar_ms]}; peak memory a rank '
          + str([None if v is None else f'{v / 2 ** 30:.2f} GiB'
                 for v in peak]) + f'; {wall_s:.1f} s of wall time, spawn '
          'included. Gloo on one card says nothing of NCCL across cards.')
    print(f'{card}: data parallel (b) a counted step a rank: '
          f'{ranks[0]["all_reduces"]} all-reduces '
          f'({ranks[0]["all_reduce_bytes_sum"] / 2 ** 20:.1f} MiB: the batch '
          'norms\' moments forward and back, the loss normalisers, the '
          'gradients, the logs) take '
          f'{[round(r["all_reduce_ms_sum"], 1) for r in ranks]} ms of a '
          f'{[round(r["counted_step_ms"], 1) for r in ranks]} ms step '
          '(host clock between synchronizes)')
    return dict(loss=ranks[0]['loss'], loss_one=one['loss'],
                loss_rel=loss_rel, min_cosine=min(cos.values()),
                min_cosine_noise=min(cos_noise.values()), cosines=cos,
                cosines_noise=cos_noise, bn_stats_of_bound=stat_err,
                launches=[r['launches'] for r in ranks], step_ms=step_ms,
                step_ms_all=[r['step_ms'] for r in ranks],
                one_process_step_ms=one['step_ms'], allreduce_ms=ar_ms,
                allreduce_bytes=ranks[0]['allreduce_bytes'],
                counted={k: [r[k] for r in ranks] for k in (
                    'all_reduces', 'all_reduce_ms_sum',
                    'all_reduce_bytes_sum', 'counted_step_ms')},
                peak_bytes=peak, wall_s=wall_s,
                losses=[r['losses'] for r in ranks])


def data_parallel_phase(torch, mods, card, tmp):
    """The sharded stage 3 and the two-rank GGA step, two processes on
    the one card (spawned: a fork after CUDA is up breaks). Main path of
    each process: its counts are set to 0 just before its run and read
    just after."""
    from gga_tpu_torch import apis

    t0 = time.perf_counter()
    res = dict(stage3=dp_stage3(torch, apis, mods, card, tmp))
    torch.cuda.empty_cache()
    res['step'] = dp_step(torch, apis, card, tmp)
    res['seconds'] = time.perf_counter() - t0
    print(f'data parallel phase: {res["seconds"]:.1f} s')
    return res


# --- the point-based KITTI detectors: 3DSSD and PointRCNN ----------------
PF_PATHS = (('configs/3dssd/3dssd_4x4_kitti-3d-car.py', 'ssd3d'),
            ('configs/point_rcnn/point_rcnn_2x8_kitti-3d-3classes.py',
             'point_rcnn'))
PF_STEPS = 1                # recorded train steps of each detector
PF_TOL = 1e-4               # card forward against the CPU's, of max|CPU|
PF_STAGES = dict(
    ssd3d=('D-FPS', 'F-FPS', 'ball query + grouping', 'SA MLPs', 'head',
           'targets + loss', 'backward', 'clip + AdamW'),
    point_rcnn=('D-FPS', 'ball query + grouping', 'SA MLPs', 'FP neck',
                'RPN + NMS', 'RoI stage', 'targets + loss', 'backward',
                'clip + AdamW'))


def car_only(batch):
    """A ``KittiDetDataset`` batch for the car config: Car (the dataset's
    label 2) as label 0, the other classes' boxes dropped (3DSSD's car
    config has ``num_classes=1``; with the dataset's labels it would meet
    no positive)."""
    car = batch['gt_valid'] & (batch['gt_labels'] == 2)
    return dict(batch, gt_labels=np.where(car, 0, -1), gt_valid=car)


@contextlib.contextmanager
def point_stage_events(torch, model, kind):
    """CUDA events around the parts of each 3DSSD or PointRCNN forward:
    each farthest point sampling (D-FPS over xyz, F-FPS over wider
    points) and grouping (``query_and_group``: ball query and gather),
    the backbone's set abstractions and aggregation layers, the head
    (3DSSD), the FP neck, the RPN head and its proposals, and the RoI
    stage (sampler, pooling, bbox head) (PointRCNN). Yields ``spans``,
    a list with one dict a forward of {part: [(start, end), ...]};
    append a dict before each forward."""
    from gga_tpu_torch.models.detectors import point_rcnn as prc
    from gga_tpu_torch.ops import points as po
    spans = []
    where = ['backbone']

    def add(key, pair):
        spans[-1].setdefault(key, []).append(pair)

    def timed(fn, key):
        def wrapper(*a, **k):
            pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            pair[0].record()
            out = fn(*a, **k)
            pair[1].record()
            name = key(a) if callable(key) else key
            add(f'{name}.{where[0]}', pair)
            return out
        return wrapper

    def hooks(module, key, region=None):
        pair = []

        def pre(*_):
            pair[:] = [torch.cuda.Event(enable_timing=True)
                       for _ in range(2)]
            pair[0].record()
            if region:
                where[0] = region

        def post(*_):
            pair[1].record()
            add(key, tuple(pair))
            if region:
                where[0] = 'backbone'
        return [module.register_forward_pre_hook(pre),
                module.register_forward_hook(post)]

    real = dict(fps=po.furthest_point_sample, qg=po.query_and_group)
    po.furthest_point_sample = timed(
        real['fps'], lambda a: 'D-FPS' if a[0].shape[-1] == 3 else 'F-FPS')
    po.query_and_group = timed(real['qg'], 'grouping')
    bb = model.backbone
    handles = [h for m in (*bb.SA_modules,
                           *(a for a in bb.aggregation_mlps if a is not None))
               for h in hooks(m, 'sa')]
    if kind == 'ssd3d':
        handles += hooks(model.bbox_head, 'head', 'head')
    else:
        real.update(props=prc.rpn_proposals, sample=prc.assign_and_sample,
                    pool=prc.roipoint_pool3d)
        prc.rpn_proposals = timed(real['props'], 'proposals')
        prc.assign_and_sample = timed(real['sample'], 'roi')
        prc.roipoint_pool3d = timed(real['pool'], 'roi')
        handles += hooks(model.neck, 'neck')
        handles += hooks(model.rpn_head, 'rpn')
        handles += hooks(model.roi_head['bbox_head'], 'bbox_head', 'head')
    try:
        yield spans
    finally:
        po.furthest_point_sample, po.query_and_group = real['fps'], real['qg']
        if kind != 'ssd3d':
            prc.rpn_proposals, prc.assign_and_sample, prc.roipoint_pool3d = (
                real['props'], real['sample'], real['pool'])
        for h in handles:
            h.remove()


def point_stage_ms(kind, spans, marks):
    """Device ms of one step by PF_STAGES[kind] from its spans and its
    marks (start, forward, loss, backward, optimizer events)."""
    def total(*keys):
        return sum(a.elapsed_time(b) for k in keys for a, b in spans.get(k,
                                                                          []))
    sampled = total('D-FPS.backbone', 'F-FPS.backbone',
                    'grouping.backbone')
    out = {'D-FPS': total('D-FPS.backbone', 'D-FPS.head'),
           'F-FPS': total('F-FPS.backbone', 'F-FPS.head'),
           'ball query + grouping': total('grouping.backbone',
                                          'grouping.head'),
           'SA MLPs': total('sa') - sampled}
    in_head = total('D-FPS.head', 'F-FPS.head', 'grouping.head')
    if kind == 'ssd3d':
        out['head'] = total('head') - in_head
    else:
        del out['F-FPS']
        out['FP neck'] = total('neck')
        out['RPN + NMS'] = total('rpn') + total('proposals.backbone')
        out['RoI stage'] = total('roi.backbone', 'bbox_head') - in_head
    out.update({'targets + loss': marks[1].elapsed_time(marks[2]),
                'backward': marks[2].elapsed_time(marks[3]),
                'clip + AdamW': marks[3].elapsed_time(marks[4])})
    return out


def max_rel_diff(torch, got, ref):
    """The largest |got - ref| over max|ref| of each float entry of two
    nested output dicts (``ref`` on the CPU), and whether their integer
    and bool entries are equal."""
    out, equal = {}, True

    def walk(g, r, name):
        nonlocal equal
        if isinstance(r, dict):
            for k in r:
                walk(g[k], r[k], f'{name}{k}.')
        elif isinstance(r, (list, tuple)):
            for i, (a, b) in enumerate(zip(g, r)):
                walk(a, b, f'{name}{i}.')
        elif torch.is_tensor(r):
            g = g.detach().cpu()
            r = r.detach()
            if r.dtype.is_floating_point:
                # equal entries (infinities too) differ by 0; a NaN where
                # the CPU has none by inf
                d = torch.where(g == r, 0.0, (g - r).abs()).nan_to_num(
                    nan=float('inf'))
                scale = float(r[torch.isfinite(r)].abs().max()) if bool(
                    torch.isfinite(r).any()) else 0.0
                out[name[:-1]] = (float(d.max()) / max(scale, 1e-30)
                                  if r.numel() else 0.0)
            elif not torch.equal(g, r):
                equal = False
                out[name[:-1]] = 'differs'
    walk(got, ref, '')
    return out, equal


def point_card_vs_cpu(torch, model, kind, batch, label):
    """The card's eval forward against the same weights' on the CPU, on
    ``batch``: the level-0 D-FPS indices the card picks alone must equal
    the CPU's; with the CPU's sampled indices given (and, for PointRCNN,
    its proposals), every output within PF_TOL of the CPU's largest
    entry. Prints, ungated, the share of each level's picks the card
    makes alone that equal the CPU's (3DSSD's F-FPS halves apart)."""
    import copy
    cpu_model = copy.deepcopy(model).cpu().eval()
    model.eval()
    pts, val = (torch.as_tensor(batch[k]) for k in ('points',
                                                    'points_valid'))
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu_model(pts, val)
        cpu_s = time.perf_counter() - t0
        alone = model(pts.to(DEVICE), val.to(DEVICE))
        if kind == 'ssd3d':
            given = model(pts.to(DEVICE), val.to(DEVICE),
                          sample_idx=[i.to(DEVICE) for i in
                                      ref['sample_idx']])
            ref_idx, card_idx = ref['sample_idx'], alone['sample_idx']
        else:
            idx = {k: [i.to(DEVICE) for i in v]
                   for k, v in ref['sample_idx'].items()}
            props = {k: v.to(DEVICE) for k, v in ref['props'].items()}
            given = model(pts.to(DEVICE), val.to(DEVICE), sample_idx=idx,
                          proposals=props)
            ref_idx = ref['sample_idx']['backbone']
            card_idx = alone['sample_idx']['backbone']
    model.train()
    if not torch.equal(card_idx[0].cpu(), ref_idx[0]):
        fail(f'{label}: the card\'s level-0 D-FPS indices differ from the '
             'CPU\'s')
    share = {}
    for lvl, (c, r) in enumerate(zip(card_idx, ref_idx)):
        c = c.cpu()
        if kind == 'ssd3d' and lvl > 0:
            half = r.shape[1] // 2            # the F-FPS half first
            share[f'level {lvl} F-FPS'] = float(
                (c[:, :half] == r[:, :half]).float().mean())
            share[f'level {lvl} D-FPS'] = float(
                (c[:, half:] == r[:, half:]).float().mean())
        else:
            share[f'level {lvl}'] = float((c == r).float().mean())
    diffs, equal = max_rel_diff(torch, given, ref)
    worst = max((v for v in diffs.values() if isinstance(v, float)),
                default=0.0)
    print(f'{label}: eval forward, card against CPU (TF32 off, the CPU\'s '
          f'sampled indices{"" if kind == "ssd3d" else " and proposals"} '
          f'given): max |d| / max|CPU| {worst:.3g} (gate {PF_TOL}), '
          f'integer and mask outputs {"equal" if equal else "DIFFER"}; '
          'the picks the card makes alone equal to the CPU\'s (not gated): '
          + ', '.join(f'{k} {v:.4f}' for k, v in share.items())
          + f'; the CPU forward {cpu_s:.1f} s')
    if not equal or worst > PF_TOL:
        bad = {k: v for k, v in diffs.items()
               if not isinstance(v, float) or v > PF_TOL}
        fail(f'{label}: card forward against the CPU: {bad}')
    del cpu_model
    return dict(max_rel_diff=worst, diffs=diffs, pick_share=share,
                cpu_forward_s=cpu_s)


def point_path(torch, mods, card, data, config, kind):
    """One point-based detector (``config`` as shipped, f32, seeded random
    weights) on the mini KITTI's trainval infos at the config's B and
    ``max_points`` (3DSSD: Car as label 0, ``car_only``):

    1. the card's eval forward against the CPU's (``point_card_vs_cpu``);
    2. main path: PF_STEPS calls of ``apis.ssd3d_train_step`` /
       ``point_rcnn_train_step`` on the config's optimizer and schedule
       (3DSSD: the lr stepped at epochs 45 and 60; PointRCNN: the cyclic
       lr of its 80 epochs), the counts set to 0 just before and read
       just after: no kernel launched, finite losses, ``num_pos`` > 0,
       each step's lr the schedule's, every parameter and BN statistic
       moved (but zero-initialised biases no gradient reached, printed:
       the RCNN's box branch where no sampled RoI is positive); CUDA
       events by PF_STAGES, scenes/s by events, peak memory;
    3. one ``infer_*`` call on a val batch: no launch, finite boxes
       [B, n, 7] (3DSSD's dims at least 0.1)."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti_det import KittiDetDataset
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.train.optim import (cyclic_cos_schedule,
                                           piecewise_constant_schedule)
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    d = cfg.data
    label = f'{kind} {Path(config).stem}'
    batch = d.samples_per_gpu

    def dataset(info, test_mode=False):
        return KittiDetDataset(data, os.path.join(data, info),
                               pc_range=cfg.point_cloud_range,
                               pts_prefix=d.pts_prefix,
                               max_points=d.max_points, seed=cfg.seed,
                               test_mode=test_mode)

    train_set = dataset(SUP_INFO)
    prep = car_only if kind == 'ssd3d' else (lambda b: b)
    batches = [prep(b) for b in train_set.epoch_batches(batch, seed=0)]
    spe = len(batches)
    if spe < PF_STEPS:
        fail(f'{label}: {len(train_set)} train scenes give {spe} batches of '
             f'{batch}, fewer than {PF_STEPS}')
    opt = dict(cfg.optimizer)
    if kind == 'ssd3d':
        trainer = apis.init_ssd3d_trainer(model_cfg, spe, device=DEVICE,
                                          seed=cfg.seed, optimizer=opt)
        sched = piecewise_constant_schedule(
            opt['lr'], {spe * e: opt['lr_gamma'] for e in opt['lr_steps']})
        step_fn = apis.ssd3d_train_step
    else:
        total = spe * cfg.max_epochs
        trainer = apis.init_point_rcnn_trainer(model_cfg, total,
                                               device=DEVICE, seed=cfg.seed,
                                               optimizer=opt)
        sched = cyclic_cos_schedule(opt['lr'], opt['lr_target_ratio'],
                                    opt['step_ratio_up'], total)
        step_fn = apis.point_rcnn_train_step
    model = trainer.model
    n_pts = int(np.asarray(batches[0]['points_valid']).sum(-1).min())
    print(f'{label}: B = {batch} x {d.max_points} points ({n_pts} valid in '
          f'the first batch\'s sparsest scene), f32, {spe} steps an epoch, '
          f'{sum(p.numel() for p in model.parameters())} parameters')
    if not all(p.device.type == DEVICE for p in model.parameters()):
        fail(f'{label}: parameters off the card')
    res = dict(config=Path(config).name, batch=batch,
               points=d.max_points, steps=PF_STEPS)

    # --- 1. the card's eval forward against the CPU's --------------------
    res['card_vs_cpu'] = point_card_vs_cpu(torch, model, kind, batches[0],
                                           label)

    # --- 2. main path ----------------------------------------------------
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    logs, lrs, marks = [], [], []
    order = ('forward', 'loss', 'backward', 'optimizer')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(mods)
    with point_stage_events(torch, model, kind) as spans:
        for i in range(PF_STEPS):
            ev = {k: torch.cuda.Event(enable_timing=True)
                  for k in ('start',) + order}
            spans.append({})
            ev['start'].record()
            logs.append(step_fn(trainer, batches[i],
                                lambda name, ev=ev: ev[name].record()))
            lrs.append(trainer.optimizer.adamw.param_groups[0]['lr'])
            marks.append([ev[k] for k in ('start',) + order])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counts(mods)
    if any(launches.values()):
        fail(f'{label}: {PF_STEPS} train steps launched {launches}; the '
             'point detectors reach no hand kernel')
    for i, (lg, lr) in enumerate(zip(logs, lrs)):
        finite_logs(torch, lg, f'{label} step {i + 1}')
        if not all(v.device.type == DEVICE for v in lg.values()):
            fail(f'{label}: step {i + 1} logs off the card')
        if not float(lg['num_pos']) > 0:
            fail(f'{label}: step {i + 1} met no positive')
        if not abs(lr - sched(i)) <= 1e-12 * sched(i):
            fail(f'{label}: step {i + 1} ran at lr {lr}, the schedule gives '
                 f'{sched(i)}')
    stuck = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n]) and bool(params0[n].any())]
    unreached = [n for n, p in model.named_parameters()
                 if torch.equal(p, params0[n]) and not params0[n].any()]
    stuck += [n for n, b in model.named_buffers()
              if torch.equal(b, stats0[n]) or not torch.isfinite(b).all()]
    if stuck:
        fail(f'{label}: {len(stuck)} tensors did not move: {stuck[:8]}')
    del params0, stats0
    step_ms = [m[0].elapsed_time(m[-1]) for m in marks]
    timed = list(range(1, PF_STEPS)) or [0]
    res['unreached'] = unreached
    stages = {k: float(np.mean([point_stage_ms(kind, spans[i], marks[i])[k]
                                for i in timed])) for k in PF_STAGES[kind]}
    res.update(step_device_ms=step_ms, stage_ms=stages, peak_bytes=peak,
               launches=launches, lrs=lrs,
               scenes_per_s_events=batch * len(timed) / (
                   sum(step_ms[i] for i in timed) / 1e3),
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {PF_STEPS} steps at B={batch} (f32): step '
          f'device ms {[round(v, 1) for v in step_ms]}, '
          f'{res["scenes_per_s_events"]:.2f} scenes/s by CUDA events (steps '
          f'{[i + 1 for i in timed]}), peak {peak / 2 ** 30:.2f} GiB; '
          f'launches {launches}; lr {lrs}')
    print(f'{card}: {label}: device ms a step by stage (events, steps '
          f'{[i + 1 for i in timed]}): ' + ', '.join(
              f'{k} {v:.1f}' for k, v in stages.items()))
    print(f'{label}: losses ' + ', '.join(
        f'{k} {[round(lg[k], 4) for lg in res["logs"]]}'
        for k in res['logs'][0])
        + (f'; zero-initialised and unreached (no positive RoI): '
           f'{unreached}' if unreached else ''))

    # --- 3. one inference call ------------------------------------------
    val = next(dataset(SUP_VAL_INFO, test_mode=True).epoch_batches(
        batch, shuffle=False))
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    infer = apis.infer_ssd3d if kind == 'ssd3d' else apis.infer_point_rcnn
    zero_counts(mods)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    det = infer(bundle, val['points'], val['points_valid'])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t1
    if any(counts(mods).values()):
        fail(f'{label}: inference launched {counts(mods)}')
    boxes = det['boxes']
    n_out = (model_cfg.head.max_out if kind == 'ssd3d'
             else model_cfg.rpn.num_proposals)
    if tuple(boxes.shape) != (batch, n_out, 7) or boxes.device.type != DEVICE:
        fail(f'{label}: inference gave boxes {tuple(boxes.shape)} on '
             f'{boxes.device}, expected ({batch}, {n_out}, 7) on the card')
    if not torch.isfinite(boxes).all():
        fail(f'{label}: non-finite boxes')
    if kind == 'ssd3d' and not bool((boxes[..., 3:6] >= 0.1).all()):
        fail(f'{label}: boxes with a dim below 0.1')
    res['infer'] = dict(seconds=infer_s, scenes_per_s=batch / infer_s,
                        kept=int(det['valid'].sum()))
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: one inference call on {batch} val scenes '
          f'{infer_s * 1e3:.1f} ms (host clock, decode and NMS included), '
          f'{res["infer"]["kept"]} boxes kept; the path '
          f'{res["seconds"]:.1f} s')
    del trainer, model, bundle
    torch.cuda.empty_cache()
    return res


def point_family_phase(torch, mods, card, tmp):
    """3DSSD and PointRCNN (``point_path`` on each PF_PATHS config) on the
    workflow's mini KITTI under ``tmp/kitti`` (its trainval infos; stage
    1's reduced clouds, ``max_points`` = 16 384 a scene)."""
    import os
    t0 = time.perf_counter()
    data = os.path.join(tmp, 'kitti')
    res = {kind: point_path(torch, mods, card, data, config, kind)
           for config, kind in PF_PATHS}
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: point family phase: {res["seconds"]:.1f} s')
    return res


# --- FreeAnchor, SSN, the RegNet backbones and PointPillars' FPN neck and
#     bf16 configs on a mini nuScenes and a mini Lyft --------------------
# trained paths: (label, config, B, steps); B is the samples a GPU of
# the config's name (mmdet3d's 4x8, 2x16, 1x16)
PL_PATHS = (
    ('free-anchor regnet-1.6gf fpn', 'configs/free_anchor/hv_pointpillars_'
     'regnet-1.6gf_fpn_sbn-all_free-anchor_4x8_2x_nus-3d.py', 4, 3),
    ('ssn secfpn nus', 'configs/ssn/hv_ssn_secfpn_sbn-all_2x16_2x_nus-3d.py',
     2, 3),
    ('ssn regnet-400mf lyft', 'configs/ssn/hv_ssn_regnet-400mf_secfpn_sbn-'
     'all_1x16_2x_lyft-3d.py', 1, 2))
# the _fp16_ config whose whole bf16 step the bf16 gate measured (the
# builder refuses the three _fp16_ PointPillars configs since: see
# ``voxelnet.refuse_pillars_bf16``)
PL_BF16 = ('configs/regnet/hv_pointpillars_regnet-400mf_fpn_sbn-all_fp16_'
           '2x8_2x_nus-3d.py')
PL_TOL = 1e-4               # card against CPU: forward of max|CPU|, loss
# the trained paths' AdamW lr: the reference's for these configs
# (mmdet3d's schedule_2x, 0.001, after a 1000-step linear warmup). The
# shipped configs' schedule_3x lr 0.008, which gga_tpu's
# tools/train_supervised.py feeds the cyclic schedule from step 0 with no
# warmup, diverges from seeded weights in both packages: FreeAnchor's
# FPN and head carry no norm, and Adam's first sign-like steps grow its
# box deltas until the decode's exp() overflows (NaN at step 2 on the
# CPU at RegNet-1.6GF's widths; ROADMAP.md §3)
PL_LR = 1e-3
PL_LYFT_SPLITS = (2, 1)     # train, val key frames of the mini Lyft
PL_LYFT_SWEEPS = 2          # past sweeps a Lyft key frame
PL_FORWARD_B = 1            # scenes of each config's forward
PL_CONFIG_COUNT = 23        # configs of the family (``pillar_configs``)
PL_BF16_B = 1               # scenes of the bf16 step against the CPU's
# the bf16 configs' whole step, the card's against the CPU's on the same
# weights and batch (cuDNN off): the port's bf16 gates (GATES['bfloat16'])
# with each gradient's cosine >= cos_min, or, where the card's own bf16
# step with one bf16 ulp of noise on the canvas parts from it further,
# within twice that distance and never below cos_floor. Missed at full
# width (PR 22): the _fp16_ configs are refused, and the phase measures
# and prints it
PL_BF16_GATE = GATES['bfloat16']
# Lyft's nine classes: (dx, dy, dz) of the SSN Lyft config's anchors and
# a top speed in m/s
PL_LYFT_CLASSES = dict(
    car=((4.75, 1.92, 1.71), 12.0), truck=((10.24, 2.84, 3.44), 10.0),
    bus=((12.70, 2.92, 3.42), 9.0),
    emergency_vehicle=((6.52, 2.42, 2.34), 12.0),
    other_vehicle=((8.17, 2.75, 3.20), 8.0),
    motorcycle=((2.35, 0.96, 1.59), 8.0), bicycle=((1.76, 0.63, 1.44), 4.0),
    pedestrian=((0.80, 0.76, 1.76), 1.5), animal=((0.73, 0.35, 0.50), 1.0))


def pillar_configs():
    """The 23 configs of FreeAnchor, SSN, the RegNet backbones and
    PointPillars' FPN neck and bf16, by path under the repository."""
    paths = []
    for family in ('free_anchor', 'regnet', 'ssn', 'pointpillars'):
        for p in sorted((ROOT / 'configs' / family).glob('*.py')):
            if family != 'pointpillars' or '_fpn_' in p.name or p.name == (
                    'hv_pointpillars_secfpn_sbn-all_fp16_2x8_2x_nus-3d.py'):
                paths.append(str(p.relative_to(ROOT)))
    return paths


def pillar_dataset(cfg, data, info, test_mode):
    """``NuScenesDataset`` or ``LyftDataset`` (by the config's
    ``dataset_type``) of the mini data, with the config's data block."""
    import os

    from gga_tpu_torch.data.nuscenes import LyftDataset, NuScenesDataset
    lyft = cfg.dataset_type == 'LyftDataset'
    root = data['lyft' if lyft else 'nuscenes']
    d = cfg.data
    return (LyftDataset if lyft else NuScenesDataset)(
        root, os.path.join(root, getattr(d, info)), max_points=d.max_points,
        max_objs=d.max_objs, sweeps_num=d.sweeps_num,
        with_velocity=d.with_velocity,
        point_cloud_range=tuple(cfg.point_cloud_range), test_mode=test_mode,
        seed=cfg.seed)


def pillar_loss(apis, model, batch, ssn):
    """The train step's loss of a train-mode forward (the apis' 7 box
    values)."""
    from gga_tpu_torch.train import loop
    b = dict(batch, gt_boxes=batch['gt_boxes'][..., :7])
    if ssn:
        return loop.ssn_loss(model, b)
    return loop.anchor_loss(model, b)


def flat_maps(out):
    """The head's maps (a dict, or SSN's list of dicts) as a list."""
    groups = out if isinstance(out, list) else [out]
    return [g[k] for g in groups for k in ('cls', 'reg', 'dir')]


def pillar_card_vs_cpu(torch, apis, model, batch, ssn, label):
    """On the first PL_FORWARD_B scenes of ``batch``, the card's eval
    forward and the loss of one train-mode forward (cuDNN off on the
    card), against the same weights' on the CPU: the maps within PL_TOL
    of the CPU's largest and the loss within PL_TOL relative."""
    import copy
    cpu = copy.deepcopy(model).cpu()
    card = copy.deepcopy(model)
    one = {k: v[:PL_FORWARD_B] for k, v in batch.items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = flat_maps(cpu.eval()(one['points'].cpu(),
                                   one['points_valid'].cpu()))
        got = flat_maps(card.eval()(one['points'], one['points_valid']))
        ref_loss = float(pillar_loss(apis, cpu.train(),
                                     {k: v.cpu() for k, v in one.items()},
                                     ssn)[0])
        with torch.backends.cudnn.flags(enabled=False):
            loss = float(pillar_loss(apis, card.train(), one, ssn)[0])
    cpu_s = time.perf_counter() - t0
    err = max(float((g.cpu() - r).abs().max()) / max(float(r.abs().max()),
                                                     1e-30)
              for g, r in zip(got, ref))
    loss_err = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    print(f'{label}: card against CPU, seeded weights: eval forward at B = '
          f'{PL_FORWARD_B}, max |d| / max|CPU| {err:.3g}; the loss of a '
          f'train-mode forward at B = {PL_FORWARD_B} (cuDNN off) '
          f'{loss:.6g} against {ref_loss:.6g}, {loss_err:.3g} relative '
          f'(gate {PL_TOL}); {cpu_s:.1f} s')
    if not (err <= PL_TOL and loss_err <= PL_TOL):
        fail(f'{label}: card against CPU: forward {err}, loss {loss_err}')
    del cpu, card
    return dict(forward_max_rel_diff=err, loss=loss, cpu_loss=ref_loss,
                loss_rel_diff=loss_err, seconds=cpu_s)


def bf16_card_vs_cpu(torch, apis, model, batch, label):
    """The bf16 config's whole step (loss, gradients, BN updates) on the
    card (cuDNN off) against the CPU's, on the same seeded weights and
    the first PL_BF16_B scenes, measured against PL_BF16_GATE (the
    builder refuses the config, so the verdict is printed, not a
    failure); the card's step with one bf16 ulp of noise on the canvas
    gives each gradient's noise cosine."""
    import copy
    one = {k: v[:PL_BF16_B] for k, v in batch.items()}

    def step(m, b, noise=False):
        m = copy.deepcopy(m).train()
        if noise:
            # the canvas bumped as ``input_ulp_noise`` bumps its input,
            # its gradient kept: x + (bumped - x) is the bumped value
            real = m.backbone.forward
            m.backbone.forward = lambda x: real(
                x + (ulp_bump(torch, x) - x).detach())
        total, _ = pillar_loss(apis, m, b, False)
        total.backward()
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in m.named_parameters() if p.grad is not None}
        stats = {n: b.detach().double().cpu() for n, b in m.named_buffers()
                 if n.endswith(('running_mean', 'running_var'))}
        return float(total.detach()), grads, stats

    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).cpu()
    ref_loss, ref_g, ref_s = step(cpu_model, {k: v.cpu()
                                              for k, v in one.items()})
    cpu_s = time.perf_counter() - t0
    with torch.backends.cudnn.flags(enabled=False):
        loss, g, s = step(model, one)
        _, g_noise, _ = step(model, one, noise=True)
    del cpu_model
    gate = PL_BF16_GATE

    def cos(a, b):
        # two zero gradients (a conv no loss term reaches) are equal
        if not (a.any() or b.any()):
            return 1.0
        return float((a * b).sum() / max(float(a.norm() * b.norm()),
                                         1e-300))

    def norm(gs):
        return float(sum(float((v ** 2).sum()) for v in gs.values()) ** 0.5)

    cosines = {n: cos(g[n], ref_g[n]) for n in ref_g}
    noise = {n: cos(g_noise[n], g[n]) for n in g}
    bad = [n for n, c in cosines.items()
           if not (c >= gate['cos_min'] or (
               c >= gate['cos_floor']
               and 1 - c <= 2 * (1 - noise[n])))]
    loss_rel = abs(loss - ref_loss) / max(abs(ref_loss), 1e-30)
    norm_rel = abs(norm(g) - norm(ref_g)) / max(norm(ref_g), 1e-30)
    bn = max(float((s[n] - ref_s[n]).abs().max())
             / max(float(ref_s[n].abs().max()), 1e-30) for n in ref_s)
    worst = min(cosines, key=cosines.get)
    print(f'{label}: bf16 step, card (cuDNN off) against CPU at B = '
          f'{PL_BF16_B}: loss {loss:.6g} against {ref_loss:.6g} ({loss_rel:.3g}'
          f' relative, gate {gate["loss"]}), grad norm {norm_rel:.3g} '
          f'relative (gate {gate["norm"]}), min cosine {cosines[worst]:.6f} '
          f'({worst}; the card\'s one-ulp noise there {noise[worst]:.6f}), '
          f'min noise cosine {min(noise.values()):.6f}, BN updates '
          f'{bn:.3g} of their largest (gate {gate["bn"]}); '
          f'{len(bad)} gradients past the cosine gate; the CPU step '
          f'{cpu_s:.1f} s')
    held = not (bad or loss_rel > gate['loss'] or norm_rel > gate['norm']
                or bn > gate['bn'])
    print(f'{label}: the bf16 gate {"holds" if held else "is missed"} '
          f'({len(bad)} of {len(cosines)} gradients past the cosine gate: '
          f'{[(n, round(cosines[n], 4), round(noise[n], 4)) for n in bad[:6]]}'
          ')')
    return dict(held=held, past_cosine=len(bad), gradients=len(cosines),
                loss=loss, cpu_loss=ref_loss, loss_rel=loss_rel,
                grad_norm_rel=norm_rel, min_cosine=cosines[worst],
                min_cosine_param=worst, noise_cosine_there=noise[worst],
                min_noise_cosine=min(noise.values()), bn_rel=bn,
                cpu_seconds=cpu_s)


def pillar_path(torch, mods, card, data, label, config, batch, steps):
    """One trained config (as shipped, f32, seeded weights) on the mini
    nuScenes or Lyft at ``batch`` scenes of up to ``data.max_points``
    points of the key frame and its sweeps:

    1. on the seeded weights, the card against the CPU: the eval forward
       and a train-mode loss (``pillar_card_vs_cpu``);
    2. main path: ``steps`` calls of ``apis.anchor_train_step`` (FreeAnchor
       and PointPillars) or ``apis.ssn_train_step`` with the config's
       optimizer as gga_tpu's ``tools/train_supervised.py`` builds it (but
       the lr, PL_LR), the counts set to 0 just before and read just
       after: no launch, finite
       losses with positives, each step's lr the cyclic schedule's, every
       parameter and BN statistic moved; device ms by stage, peak memory;
    3. ``calibrate_bn`` on the first batch, ``infer_anchor`` or
       ``infer_ssn`` on the val key frames (no launch, finite boxes), then
       ``format_results`` and ``nuscenes_eval`` (mAP, NDS finite) or
       ``lyft_eval`` (mAP finite); no AP is a gate at random weights."""
    import math

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.eval.lyft_eval import lyft_eval
    from gga_tpu_torch.eval.nuscenes_eval import nuscenes_eval
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.models.detectors.ssn import SSNConfig
    from gga_tpu_torch.train.optim import cyclic_cos_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    model_cfg = build_detector(cfg)[1]
    lyft = cfg.dataset_type == 'LyftDataset'
    keys = ('points', 'points_valid', 'gt_boxes', 'gt_labels', 'gt_valid')
    train = pillar_dataset(cfg, data, 'train_info', False)
    spe = len(train) // batch
    batches = []
    for epoch in range(math.ceil(steps / spe)):
        train.epoch = epoch
        batches += [{k: torch.as_tensor(b[k], device=DEVICE) for k in keys}
                    for b in train.epoch_batches(batch, seed=epoch)]
    batches = batches[:steps]
    o = cfg.optimizer
    opt = dict(lr=PL_LR, weight_decay=o.weight_decay, grad_clip=o.grad_clip,
               betas=tuple(o.get('betas', (0.95, 0.99))))
    total = spe * cfg.max_epochs
    ssn = isinstance(model_cfg, SSNConfig)
    init = apis.init_ssn_trainer if ssn else apis.init_anchor_trainer
    trainer = init(model_cfg, total, device=DEVICE, seed=cfg.seed,
                   optimizer=opt)
    model = trainer.model
    print(f'{label}: {Path(config).name}, {type(model).__name__} '
          f'{model_cfg.backbone}, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters, canvas '
          f'{model_cfg.scatter_shape}, {model_cfg.max_voxels} pillars; '
          f'B = {batch} x {cfg.data.max_points} points of '
          f'{cfg.data.sweeps_num + 1} sweeps, {spe} steps an epoch, {total} '
          f'in all; batches loaded in {time.perf_counter() - t0:.1f} s')
    res = dict(config=Path(config).name, batch=batch)

    # --- 1. the card against the CPU, on the seeded weights --------------
    res['card_vs_cpu'] = pillar_card_vs_cpu(torch, apis, model, batches[0],
                                            ssn, label)

    # --- 2. main path ----------------------------------------------------
    sched = cyclic_cos_schedule(opt['lr'], (10, 1e-4), 0.4, total)
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    step_fn = apis.ssn_train_step if ssn else apis.anchor_train_step
    torch.cuda.empty_cache()
    logs, lrs, marks, launches, peak, _ = recorded_steps(
        torch, mods, trainer, step_fn, batches, label)
    if any(launches.values()):
        fail(f'{label}: {steps} train steps launched {launches}; the pillar '
             'detectors reach no hand kernel')
    # FreeAnchor's num_pos counts the valid GTs; the max-IoU heads' counts
    # positive anchors, none where no class's anchors fit its labels' boxes
    # (the nuScenes and Lyft configs list their anchors in SSN's class
    # order, the datasets label in theirs: ROADMAP.md §3), and then no
    # gradient reaches the box and direction convs' zero biases
    positives = [float(lg['num_pos']) for lg in logs]
    unreached = () if any(positives) else [
        n for n, _ in model.named_parameters()
        if n.endswith(('conv_reg.bias', 'conv_dir_cls.bias'))]
    step_ms, stages = step_checks(torch, trainer, logs, lrs, sched, params0,
                                  stats0, marks, label, num_pos=None,
                                  unreached=unreached)
    del params0, stats0
    timed = list(range(1, steps)) or [0]
    res.update(steps=steps, step_device_ms=step_ms, stage_ms=stages,
               peak_bytes=peak, launches=launches, lrs=lrs,
               positives=positives,
               scenes_per_s_events=batch * len(timed) / (
                   sum(step_ms[i] for i in timed) / 1e3),
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {steps} steps at B = {batch}: step device ms '
          f'{[round(v, 1) for v in step_ms]}, {res["scenes_per_s_events"]:.2f}'
          f' scenes/s by CUDA events (steps {[i + 1 for i in timed]}), '
          f'by stage ' + ', '.join(f'{k} {v:.1f}' for k, v in stages.items())
          + f', peak {peak / 2 ** 30:.2f} GiB; launches {launches}; lr {lrs}'
          f'; num_pos {positives}')
    print(f'{label}: losses ' + ', '.join(
        f'{k} {[round(lg[k], 4) for lg in res["logs"]]}'
        for k in res['logs'][0]))

    # --- 3. inference on the val key frames and the eval -----------------
    calibrate_bn(torch, model, batches[0])
    del batches
    torch.cuda.empty_cache()
    val = pillar_dataset(cfg, data, 'val_info', True)
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    infer = apis.infer_ssn if ssn else apis.infer_anchor
    detections, ms = [], []
    zero_counts(mods)
    for vb in val.epoch_batches(batch, shuffle=False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = infer(bundle, vb['points'], vb['points_valid'])
        end.record()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        ms.append(start.elapsed_time(end))
        for j in range(len(vb['points'])):
            v = out['valid'][j]
            detections.append(dict(boxes_3d=out['boxes'][j][v],
                                   scores_3d=out['scores'][j][v],
                                   labels_3d=out['labels'][j][v]))
    got = counts(mods)
    if any(got.values()) or len(detections) != len(val):
        fail(f'{label}: inference launched {got} over {len(detections)} '
             f'key frames of {len(val)}')
    if not all(np.isfinite(x['boxes_3d']).all() for x in detections):
        fail(f'{label}: inference gave non-finite boxes')
    # the labels are the head's class indices, named by the dataset's
    # classes, as in gga_tpu (ROADMAP.md §3: the nuScenes configs' anchors
    # are in SSN's order, the labels in NUS_CLASSES')
    preds = [dict(boxes=x['boxes_3d'], scores=x['scores_3d'],
                  names=np.array([val.CLASSES[int(c)]
                                  for c in x['labels_3d']]))
             for x in detections]
    gts = val.eval_ground_truth()
    if lyft:
        metrics = lyft_eval(gts, preds, val.CLASSES)
        metric_keys = ('mAP',)
    else:
        sub = val.format_results(detections)
        if sorted(sub['results']) != sorted(i['token']
                                            for i in val.data_infos):
            fail(f'{label}: format_results gave {len(sub["results"])} '
                 'samples')
        metrics = nuscenes_eval(gts, preds)
        metric_keys = ('mAP', 'NDS')
    if not all(k in metrics and np.isfinite(metrics[k])
               for k in metric_keys):
        fail(f'{label}: the eval gave no finite {metric_keys}: {metrics}')
    n_det = sum(len(x['scores_3d']) for x in detections)
    res['eval'] = dict(scenes=len(detections), forward_ms=ms,
                       scenes_per_s=len(detections) / (sum(ms) / 1e3),
                       detections=n_det, launches=got,
                       **{k: metrics[k] for k in metric_keys})
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: {infer.__name__} on {len(detections)} val key '
          f'frames (batches of {batch}): {res["eval"]["scenes_per_s"]:.2f} '
          f'scenes/s by CUDA events around each call, {n_det} detections; '
          f'{"lyft_eval" if lyft else "format_results, nuscenes_eval"} '
          + ', '.join(f'{k} {metrics[k]:.4g}' for k in metric_keys)
          + f' (random weights); the path {res["seconds"]:.1f} s')
    del trainer, model, bundle
    torch.cuda.empty_cache()
    return res


def pillar_bf16(torch, card, data):
    """The bf16 gate on PL_BF16 at full width: the builder and
    ``apis.init_anchor_detector`` refuse the config; its detector built
    directly, with seeded weights, takes ``bf16_card_vs_cpu`` on the
    first train batch (printed, as the configs stay refused)."""
    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.models.builder import build_detector, config_from_dict
    from gga_tpu_torch.models.detectors.voxelnet import (PointPillars,
                                                         PointPillarsConfig)
    t0 = time.perf_counter()
    label = Path(PL_BF16).stem
    cfg = Config.fromfile(str(ROOT / PL_BF16))
    model_cfg = config_from_dict(PointPillarsConfig, dict(cfg.model))
    for build in (lambda: build_detector(cfg),
                  lambda: apis.init_anchor_detector(model_cfg,
                                                    device=DEVICE)):
        try:
            build()
        except NotImplementedError:
            continue
        fail(f'{label}: the bf16 config built')
    model = PointPillars(model_cfg)
    model.init_weights(torch.Generator().manual_seed(cfg.seed))
    model = model.to(DEVICE)
    train = pillar_dataset(cfg, data, 'train_info', False)
    b = next(train.epoch_batches(PL_BF16_B, seed=0))
    b = {k: torch.as_tensor(b[k], device=DEVICE) for k in (
        'points', 'points_valid', 'gt_boxes', 'gt_labels', 'gt_valid')}
    res = bf16_card_vs_cpu(torch, apis, model, b, f'{card}: {label}')
    res['seconds'] = time.perf_counter() - t0
    del model, b
    torch.cuda.empty_cache()
    return res


def pillar_forwards(torch, mods, card, data):
    """Each of the PL_CONFIG_COUNT configs (``pillar_configs``) built on
    the card with
    seeded weights: ``calibrate_bn`` on its dataset's first train scene,
    then one eval forward at B = PL_FORWARD_B; no launch, finite maps,
    the peak memory."""
    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.models.detectors.ssn import SSNConfig
    res = {}
    for config in pillar_configs():
        t0 = time.perf_counter()
        cfg = Config.fromfile(str(ROOT / config))
        if '_fp16_' in config:
            try:
                build_detector(cfg)
            except NotImplementedError as e:
                res[config] = dict(refused=str(e))
                print(f'{Path(config).name}: refused by the builder (bf16)')
                continue
            fail(f'{config}: the bf16 config built')
        model_cfg = build_detector(cfg)[1]
        ds = pillar_dataset(cfg, data, 'train_info', False)
        b = next(ds.epoch_batches(PL_FORWARD_B, shuffle=False))
        b = {k: torch.as_tensor(b[k], device=DEVICE)
             for k in ('points', 'points_valid')}
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(mods)
        init = (apis.init_ssn_detector if isinstance(model_cfg, SSNConfig)
                else apis.init_anchor_detector)
        bundle = init(model_cfg, device=DEVICE, seed=cfg.seed)
        calibrate_bn(torch, bundle.model, b)
        with torch.no_grad():
            maps = flat_maps(bundle.model(b['points'], b['points_valid']))
        torch.cuda.synchronize()
        got = counts(mods)
        peak = torch.cuda.max_memory_allocated()
        if any(got.values()):
            fail(f'{config}: its forward launched {got}')
        if not all(bool(torch.isfinite(m).all()) for m in maps):
            fail(f'{config}: non-finite maps')
        res[config] = dict(peak_bytes=peak, anchors_maps=[
            tuple(m.shape) for m in maps], seconds=time.perf_counter() - t0)
        print(f'{card}: {Path(config).name}: {type(bundle.model).__name__} '
              f'{getattr(model_cfg, "compute_dtype", "float32")}, forward '
              f'at B = {PL_FORWARD_B} finite, peak {peak / 2 ** 30:.2f} GiB '
              f'(build, calibrate_bn and forward {res[config]["seconds"]:.1f} '
              's)')
        del bundle, maps, b
    if len(res) != PL_CONFIG_COUNT:
        fail(f'{len(res)} pillar-family configs, expected {PL_CONFIG_COUNT}')
    return res


def pillar_family_phase(torch, mods, card, tmp):
    """FreeAnchor, SSN, the RegNet backbones and PointPillars' FPN neck
    and bf16 configs: a mini nuScenes (the CenterPoint phase's, written
    here if it is not there) and a mini Lyft of Lyft's nine classes
    (``write_mini_nuscenes(..., name='lyft')``), each PL_PATHS config
    through ``pillar_path``, the bf16 gate (``pillar_bf16``) and all 23
    configs through ``pillar_forwards``."""
    import os
    t0 = time.perf_counter()
    data = dict(nuscenes=os.path.join(tmp, 'nuscenes'),
                lyft=os.path.join(tmp, 'lyft'))
    if not os.path.exists(os.path.join(data['nuscenes'],
                                       'nuscenes_infos_train.pkl')):
        write_mini_nuscenes(data['nuscenes'], CP_SPLITS)
    write_mini_nuscenes(data['lyft'], PL_LYFT_SPLITS, PL_LYFT_SWEEPS,
                        classes=PL_LYFT_CLASSES, name='lyft')
    print(f'pillar family phase: mini nuScenes {CP_SPLITS} key frames x '
          f'{CP_SWEEPS + 1} sweeps and Lyft {PL_LYFT_SPLITS} x '
          f'{PL_LYFT_SWEEPS + 1} ready in {time.perf_counter() - t0:.1f} s')
    res = {label: pillar_path(torch, mods, card, data, label, config, b, n)
           for label, config, b, n in PL_PATHS}
    res['bf16'] = pillar_bf16(torch, card, data)
    res['forwards'] = pillar_forwards(torch, mods, card, data)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: pillar family phase: {res["seconds"]:.1f} s')
    return res


# --- the monocular KITTI detectors: SMOKE and MonoFlex ---------------------
MO_PATHS = (
    ('smoke', 'configs/smoke/smoke_dla34_dlaneck_gn-all_8x4_6x_kitti-mono3d.py'),
    ('monoflex', 'configs/monoflex/'
     'monoflex_dla34_dlaneck_gn-all_2x4_6x_kitti-mono3d.py'))
MO_INFO = 'kitti_infos_trainval_GGA.pkl'   # the workflow's 16 scenes
MO_STEPS = 2                # recorded train steps of each; the first warms up
MO_TOL = 1e-4               # card forward against the CPU's, of max|CPU|
# kernel #7's maps of a SMOKE step at 384 x 1248: B x 3 classes of 96 x 312
MO_HEATMAP_HW = (96, 312)


def mono_card_vs_cpu(torch, model, images, label):
    """The card's eval forward of a batch against the same weights' on the
    CPU: both head maps within MO_TOL of the CPU's largest entry."""
    import copy
    cpu = copy.deepcopy(model).cpu().eval()
    x = images.permute(0, 3, 1, 2).contiguous()
    t0 = time.perf_counter()
    with torch.no_grad():
        ref = cpu(x.cpu())
        cpu_s = time.perf_counter() - t0
        got = model.eval()(x)
    errs = {k: float((got[k].cpu() - ref[k]).abs().max())
            / max(float(ref[k].abs().max()), 1e-30) for k in ref}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    print(f'{label}: eval forward at B = {len(x)}, card against CPU (TF32 '
          f'off): max |d| / max|CPU| ' + ', '.join(
              f'{k} {v:.3g}' for k, v in errs.items())
          + f' (gate {MO_TOL}); the CPU forward {cpu_s:.1f} s')
    if not finite or not max(errs.values()) <= MO_TOL:
        fail(f'{label}: card forward against the CPU: {errs}, finite '
             f'{finite}')
    del cpu
    return dict(max_rel_diff=errs, cpu_forward_s=cpu_s)


def dead_projections(model):
    """Parameters of the DLA trees' discarded projections (a tree of more
    than one level projects its input and drops it, as gga_tpu's): they
    take no gradient."""
    from gga_tpu_torch.models.backbones.dla import Tree
    return [f'{name}.project.{p}' for name, m in model.named_modules()
            if isinstance(m, Tree) and m.levels > 1 and m.project is not None
            for p, _ in m.project.named_parameters()]


def monoflex_unreached(torch, model, batches, logs):
    """MonoFlex's parameters that a step can leave without gradient, by
    what the step's data show: the 2D-box branch where every object's IoU
    sat at the loss's floor (-log of the 1e-6 clip) in every step, and the
    offsets' edge fusion (its outputs land on the map's border only) where
    no object counted sits on the border."""
    import math

    from gga_tpu_torch import apis
    from gga_tpu_torch.models.dense_heads import monoflex_head as mh
    head = model.cfg.head
    floor = head.loss_bbox_weight * -math.log(1e-6)
    names = []
    if all(abs(float(lg['loss_bbox']) - floor) <= 1e-6 * floor
           for lg in logs):
        names += ['conv_reg_prevs.0.', 'conv_regs.0.']
    on_border = False
    for b in batches:
        mb = apis.mono3d_batch(DEVICE, b, head.down_ratio)
        H, W = (s // head.down_ratio for s in mb['img'].shape[2:])
        t = mh.build_targets(head, mb['gt_boxes_cam'], mb['gt_labels'],
                             mb['gt_bboxes'], mb['centers2d'], mb['depths'],
                             mb['obj_valid'], mb['cam2img'],
                             tuple(mb['img'].shape[2:]), (H, W))
        x, y = t['base_int'][..., 0], t['base_int'][..., 1]
        edge = (x == 0) | (x == W - 1) | (y == 0) | (y == H - 1)
        on_border |= bool((edge & t['valid']).any())
    if not on_border:
        names.append('edge_fuse_reg.')
    return [n for n, _ in model.named_parameters()
            if n.startswith(tuple(f'bbox_head.{m}' for m in names))]


def mono_path(torch, mods, card, data, label, config):
    """One monocular config as shipped (f32, seeded weights) on the mini
    KITTI's images through ``KittiMonoDataset``, at its
    ``data.samples_per_gpu``:

    1. the card's eval forward of the first batch against the CPU's
       (``mono_card_vs_cpu``);
    2. main path: MO_STEPS calls of ``apis.smoke_train_step`` or
       ``apis.monoflex_train_step`` with the config's optimizer block, the
       counts set to 0 just before and read just after: SMOKE's heatmap
       targets one ``render_heatmap`` launch a step (B x 3 maps of 96 x
       312), no other launch; finite losses with positives, each step's
       lr the schedule's, every parameter and batch-norm statistic moved
       but those no gradient reaches (the discarded projections; MonoFlex's
       ``monoflex_unreached``); device ms by stage after the first step,
       peak memory; then a profile of one more step;
    3. each recorded ``render_heatmap`` call replayed against its plain
       version (``heatmap_rows``: 1e-6, the same pixels at 1.0);
    4. ``apis.infer_smoke`` / ``infer_monoflex`` on the first batch and
       ``apis.inference_mono_3d_detector`` on one image: no launch, finite
       boxes."""
    import os

    from gga_tpu_torch import apis
    from gga_tpu_torch.config import Config
    from gga_tpu_torch.data.kitti.mono_dataset import KittiMonoDataset
    from gga_tpu_torch.kernels import heatmap
    from gga_tpu_torch.models.builder import build_detector
    from gga_tpu_torch.train.optim import piecewise_constant_schedule
    t0 = time.perf_counter()
    cfg = Config.fromfile(str(ROOT / config))
    with torch.device('meta'):
        meta_model, model_cfg = build_detector(cfg)
    flop = forward_flop(torch, meta_model)
    del meta_model
    batch = cfg.data.samples_per_gpu
    ds = KittiMonoDataset(data, os.path.join(data, MO_INFO),
                          max_objs=cfg.data.max_objs)
    spe = len(ds) // batch
    batches = [{k: torch.as_tensor(v, device=DEVICE) for k, v in b.items()}
               for b in ds.epoch_batches(batch, seed=0)][:MO_STEPS]
    if len(batches) < MO_STEPS:
        fail(f'{label}: {len(ds)} images give {len(batches)} batches of '
             f'{batch}')
    smoke = label == 'smoke'
    init = apis.init_smoke_trainer if smoke else apis.init_monoflex_trainer
    step_fn = apis.smoke_train_step if smoke else apis.monoflex_train_step
    infer = apis.infer_smoke if smoke else apis.infer_monoflex
    o = cfg.optimizer
    trainer = init(model_cfg, spe, dict(o), device=DEVICE,
                   seed=cfg.get('seed', 0))
    model = trainer.model
    print(f'{label}: {Path(config).name}, {type(model).__name__} DLA-'
          f'{model_cfg.img_depth} + DLANeck, f32, '
          f'{sum(p.numel() for p in model.parameters())} parameters; '
          f'{flop / 1e9:.2f} GFLOP a 384 x 1248 forward (counted from '
          f'shapes), a step of {batch} about 3x that an image: '
          f'{3 * batch * flop / 1e12:.3f} TFLOP; B = {batch}, {spe} steps '
          f'an epoch; lr {o.lr}, clip {o.grad_clip or None}; data in '
          f'{time.perf_counter() - t0:.1f} s')
    res = dict(config=Path(config).name, batch=batch, forward_flop=flop)

    # --- 1. the card against the CPU, on the seeded weights --------------
    res['card_vs_cpu'] = mono_card_vs_cpu(torch, model, batches[0]['image'],
                                          label)

    # --- 2. main path ----------------------------------------------------
    sched = piecewise_constant_schedule(
        o.lr, {spe * e: o.lr_gamma for e in o.lr_steps})
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.empty_cache()
    logs, lrs, marks, launches, peak, rec = recorded_steps(
        torch, mods, trainer, step_fn, batches, label,
        record=((heatmap, 'render_heatmap'),))
    want = {k: 0 for k in launches}
    want['render_heatmap'] = MO_STEPS if smoke else 0
    if launches != want:
        fail(f'{label}: {MO_STEPS} train steps launched {launches}, expected '
             f'{want}')
    unreached = dead_projections(model) + ([] if smoke else
                                           monoflex_unreached(
                                               torch, model, batches, logs))
    step_ms, stages = step_checks(torch, trainer, logs, lrs, sched, params0,
                                  stats0, marks, label, unreached=unreached)
    del params0, stats0
    res.update(steps=MO_STEPS, step_device_ms=step_ms, stage_ms=stages,
               peak_bytes=peak, launches=launches, lrs=lrs,
               unreached=unreached,
               images_per_s_events=batch / (step_ms[-1] / 1e3),
               tflop_per_s_events=3 * batch * flop / (step_ms[-1] / 1e3)
               / 1e12,
               logs=[{k: float(v) for k, v in lg.items()} for lg in logs])
    print(f'{card}: {label}: {MO_STEPS} steps at B = {batch}: step device ms '
          f'{[round(v, 1) for v in step_ms]}; after the first, by stage '
          + ', '.join(f'{k} {v:.1f}' for k, v in stages.items())
          + f' ({res["images_per_s_events"]:.2f} images/s, '
          f'{res["tflop_per_s_events"]:.2f} TFLOP/s at 3 forwards an image)'
          f', peak {peak / 2 ** 30:.2f} GiB; launches {launches}; lr {lrs}; '
          f'num_pos {[lg["num_pos"] for lg in res["logs"]]}; no gradient '
          f'(not checked for moving): {unreached}')
    print(f'{label}: losses ' + ', '.join(
        f'{k} {[round(lg[k], 4) for lg in res["logs"]]}'
        for k in res['logs'][0]))

    # a profile of one more step (outside the counted run)
    res['profile'] = device_profile(torch, lambda: step_fn(
        trainer, batches[-1]))
    print_profile(f'{card}: {label} train step', res['profile'])

    # --- 3. kernel #7's recorded calls against the plain renderer ---------
    torch.set_grad_enabled(False)
    try:
        calls = rec['render_heatmap']
        res['heatmap'] = heatmap_rows(torch, heatmap, calls, label) \
            if calls else []
    finally:
        torch.set_grad_enabled(True)
    if smoke and any((r['H'], r['W']) != MO_HEATMAP_HW
                     or r['G'] != 3 * batch for r in res['heatmap']):
        fail(f'{label}: render_heatmap rendered '
             f'{[(r["G"], r["H"], r["W"]) for r in res["heatmap"]]}')
    del rec, calls

    # --- 4. inference ----------------------------------------------------
    bundle = apis.DetectorBundle(model, model_cfg, torch.device(DEVICE))
    images, cam2img = batches[0]['image'], batches[0]['cam2img']
    zero_counts(mods)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = infer(bundle, images, cam2img)
    end.record()
    one = apis.inference_mono_3d_detector(bundle, images[0].cpu().numpy(),
                                          cam2img[0].cpu().numpy())
    got = counts(mods)
    if any(got.values()):
        fail(f'{label}: inference launched {got}')
    if not (bool(torch.isfinite(out['boxes']).all())
            and np.isfinite(one['boxes_3d']).all()):
        fail(f'{label}: inference gave non-finite boxes')
    ms = start.elapsed_time(end)
    keep = out['valid'] if 'valid' in out else out['scores'] > 0.25
    res['infer'] = dict(ms=ms, images_per_s=batch / (ms / 1e3),
                        kept=int(keep.sum()), single_kept=len(one['scores_3d']),
                        launches=got)
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: {label}: {infer.__name__} on {batch} images: {ms:.1f} ms '
          f'by CUDA events ({res["infer"]["images_per_s"]:.1f} images/s), '
          f'{res["infer"]["kept"]} boxes kept; inference_mono_3d_detector on '
          f'one image: {res["infer"]["single_kept"]} boxes; the path '
          f'{res["seconds"]:.1f} s')
    del trainer, model, bundle, batches, out
    torch.cuda.empty_cache()
    return res


def mono_family_phase(torch, mods, card, tmp):
    """SMOKE and MonoFlex (``mono_path`` on each MO_PATHS config) on the
    workflow phase's mini KITTI (``tmp/kitti``; written here with its
    infos if it is not there)."""
    import os

    from gga_tpu_torch.tools import create_data_gga
    t0 = time.perf_counter()
    data = os.path.join(tmp, 'kitti')
    if not os.path.exists(os.path.join(data, MO_INFO)):
        write_mini_kitti(data)
        create_data_gga.main(['kitti', '--root-path', data,
                              '--workers', str(os.cpu_count() or 8)])
    res = {label: mono_path(torch, mods, card, data, label, config)
           for label, config in MO_PATHS}
    res['seconds'] = time.perf_counter() - t0
    print(f'{card}: mono family phase: {res["seconds"]:.1f} s')
    return res


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
        torch.cuda.empty_cache()
        # --- indoor stage 1, FCAF3D on ScanNet, VoteNet ---
        fam = indoor_family_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- GroupFree3D, H3DNet and ImVoteNet on the same data ---
        vd = vote_derived_phase(torch, mods, card, fam['data'])
        torch.cuda.empty_cache()
        # --- the segmentors on the same ScanNet and a mini S3DIS ---
        seg = segmentation_phase(torch, mods, card, fam['data'], tmp)
        torch.cuda.empty_cache()
        # --- MVXNet and ImVoxelNet on the mini KITTI and SUN RGB-D ---
        fu = fusion_phase(torch, mods, card, tmp, fam['data'])
        torch.cuda.empty_cache()
        # --- the sharded stage 3 and the two-rank GGA step ---
        dp = data_parallel_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- the point-based KITTI detectors: 3DSSD and PointRCNN ---
        pf = point_family_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- FreeAnchor, SSN, RegNet, FPN and bf16 on nuScenes and Lyft ---
        pl = pillar_family_phase(torch, mods, card, tmp)
        torch.cuda.empty_cache()
        # --- SMOKE and MonoFlex on the mini KITTI's images ---
        mo = mono_family_phase(torch, mods, card, tmp)

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
    # FCAF3D's steps on ScanNet (f32, B = 2 x 40 000 points): the two
    # sparse-conv kernels
    sn = fam['fcaf3d_scannet']
    for entry, key, rows in (
            (kernels[2], 'gather_gemm_conv', sn['conv_calls']),
            (kernels[3], 'gather_gemm_dw', sn['dw_calls'])):
        e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                         entry['replaces'], sn['launches'][key], rows)
        entry['scannet'] = {k: e[k] for k in (
            'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
            'ffma_bound_ms', 'library_ms')}
    # the point-based detectors reach no kernel: their launches, 0
    for entry in kernels:
        entry['point_family'] = dict(launches=sum(
            pf[kind]['launches'].get(entry['name'].replace('_f32', ''), 0)
            for _, kind in PF_PATHS))
    # nor do the VoteNet-derived indoor detectors: their launches, 0
    for entry in kernels:
        name = entry['name'].replace('_f32', '')
        entry['vote_derived'] = dict(launches=sum(
            r.get('launches', {}).get(name, 0)
            + r['infer']['launches'].get(name, 0)
            for k, r in vd.items() if k != 'seconds'))
    # nor do the segmentors: their launches, 0
    for entry in kernels:
        name = entry['name'].replace('_f32', '')
        entry['segmentation'] = dict(launches=sum(
            r['launches'].get(name, 0) + r['infer']['launches'].get(name, 0)
            for k, r in seg.items() if k != 'seconds'))
    # nor do FreeAnchor, SSN and the RegNet / FPN / bf16 pillar configs:
    # their steps' and inferences' launches, 0
    for entry in kernels:
        name = entry['name'].replace('_f32', '')
        entry['pillar_family'] = dict(launches=sum(
            r['launches'].get(name, 0)
            + r.get('eval', {}).get('launches', {}).get(name, 0)
            for label, *_ in PL_PATHS for r in (pl[label],)))
    # SMOKE's steps: render_heatmap once a step (its heatmap targets);
    # MonoFlex reaches no kernel
    for entry in kernels:
        name = entry['name'].replace('_f32', '')
        n = sum(mo[label]['launches'].get(name, 0)
                + mo[label]['infer']['launches'].get(name, 0)
                for label, _ in MO_PATHS)
        if name == 'render_heatmap':
            e = kernel_entry(entry['name'], 'heatmap.cu', entry['replaces'],
                             n, mo['smoke']['heatmap'])
            entry['mono_family'] = {k: e[k] for k in (
                'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
                'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
                'library_ms', 'host_ms')}
        else:
            entry['mono_family'] = dict(launches=n)
    # MVXNet's steps (f32, B = 2): conv, dW and gather_rows; the
    # ImVoxelNet paths reach no kernel
    mvx = fu['mvxnet']
    fu_rows = {'gather_gemm_conv_f32': (mvx['conv_calls'], None),
               'gather_gemm_dw_f32': (mvx['dw_calls'], None),
               'gather_rows': (mvx['gather_rows'], sum(
                   r['library_ms'] for r in mvx['gather_rows']))}
    for entry in kernels:
        name = entry['name'].replace('_f32', '')
        imv = sum(r['launches'].get(name, 0)
                  + r['infer']['launches'].get(name, 0)
                  for k, r in fu.items() if k.startswith('imvoxelnet_'))
        # the two sparse-conv wrappers' launches split by dtype between
        # their f32 and bf16 entries (the recorded calls)
        n = (mvx['launches_by_dtype'][name][
            'float32' if entry['name'].endswith('_f32') else 'bfloat16']
            if name in mvx['launches_by_dtype'] and name != 'gather_rows'
            else mvx['launches'][name])
        if entry['name'] in fu_rows:
            rows, lib = fu_rows[entry['name']]
            e = kernel_entry(entry['name'], entry['source'].split('/')[-1],
                             entry['replaces'], n, rows, library_ms=lib)
            entry['fusion'] = {k: e[k] for k in (
                'launches', 'max_abs_err', 'ms', 'device_ms', 'plain_ms',
                'bound_ms', 'bound_by', 'bound_share', 'device_bound_share',
                'ffma_bound_ms', 'library_ms')}
        else:
            entry['fusion'] = dict(launches=n)
        entry['fusion']['imvoxelnet_launches'] = imv
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
                            ('scannet', sn['steps']),
                            ('fusion', mvx['steps']),
                            ('mono_family', mo['smoke']['steps']),
                            *((t, vf[t]['train']['steps'])
                              for t, _ in VF_PATHS)):
            if 'ms' not in k.get(path, {}):
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
                       centerpoint=cp, parta2=pa, indoor_family=fam,
                       data_parallel=dp, point_family=pf,
                       vote_derived=vd, segmentation=seg, fusion=fu,
                       pillar_family=pl, mono_family=mo),
                  fh, indent=1, default=str)

    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
