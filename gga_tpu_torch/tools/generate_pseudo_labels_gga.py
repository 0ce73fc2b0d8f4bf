"""Stage 3: pseudo-3D-label generation, its scenes sharded over processes
(the port's copy of ``tools/generate_pseudo_labels_gga.py``).

Equivalent of the reference's generate_pseudo_labels_gga.py +
KittiDataset_GGA_match.evaluate (kitti_dataset_GGA_match.py:421): run
batched inference over the info split the matching config names (each
batch padded to ``cfg.data.max_points`` points a scene), convert to KITTI
annos, match against the 2D GT by image-plane IoU, dump the pseudo info
pkl, and with ``--eval`` report KITTI AP against the (debug-only) 3D GT.

The scenes are sharded over ``--world`` processes
(``parallel.dist_eval``: rank r runs scenes r, r + world, ...), each
dumps its part under ``--tmpdir`` (default ``<work_dir>/eval_parts``, as
gga_tpu), and rank 0 merges them in the one-process order, matches and
writes the pkl; the other ranks print and exit after dumping. The ranks
are plain processes given ``--rank`` and ``--world`` (they may share a
card), or a ``torchrun`` launch, whose group gives both and whose ranks
run on ``cuda:LOCAL_RANK``. ``--batch-size`` is per process. Without a
card the tool raises unless ``--device cpu``.

Usage:
    [torchrun --nproc-per-node N] -m gga_tpu_torch.tools.generate_pseudo_labels_gga \\
        configs/gga/gga_kitti_matching.py \\
        --checkpoint work_dirs/kitti_GGA/checkpoints [--eval] \\
        [--out PKL] [--batch-size B] [--device cuda|cpu] \\
        [--rank R --world W] [--tmpdir DIR] \\
        [--cfg-options k.ey=val ...]
(``python -m gga_tpu_torch.tools.generate_pseudo_labels_gga ...`` for
one process or for a rank given ``--rank`` / ``--world``.)

The matching config names the split + pseudo-pkl destination
(``matching = dict(info=..., out=...)``); ``--out`` overrides.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

from ..data.kitti.pseudo_labels import pseudo_label_matching
from ..eval.kitti_eval import kitti_eval
from ..eval.submission import detections_to_kitti_annos
from ..parallel import mesh
from ..parallel.dist_eval import run_sharded_inference, shard_indices
from ..tools_lib import build_model_from_cfg
from .train import add_dist_args, launch, load_config

CLASSES = ('Pedestrian', 'Cyclist', 'Car')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', required=True,
                   help='checkpoint dir; its newest checkpoint is loaded')
    p.add_argument('--out', default=None)
    p.add_argument('--eval', action='store_true',
                   help='also report KITTI AP vs the 3D GT (debug)')
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--device', default='cuda')
    p.add_argument('--tmpdir', default=None,
                   help='shared dir for multi-process result collect '
                        '(the reference multi_gpu_test tmpdir '
                        'mechanism); default work-dir local')
    p.add_argument('--rank', type=int, default=None,
                   help='this process\'s rank (default: the torchrun '
                        'group\'s, else 0)')
    p.add_argument('--world', type=int, default=None,
                   help='process count (default: the torchrun group\'s, '
                        'else 1)')
    add_dist_args(p)
    p.add_argument('--cfg-options', nargs='*', default=[])
    args = p.parse_args(argv)
    # a rank without its world, or a world without this process's rank,
    # would merge a partial run or wait for parts that never come
    if (args.rank is None) != (args.world is None):
        p.error('--rank and --world go together')
    if args.world is not None and not 0 <= args.rank < args.world:
        p.error(f'--rank {args.rank} is outside --world {args.world}')
    return args


def main(argv=None):
    """Returns dict(infos, out, seconds (load through matching),
    scenes_per_s, and with --eval the KITTI AP dict ``ap``) on rank 0;
    dict(rank, scenes, seconds) on the other ranks."""
    args = parse_args(argv)
    dev, _, world = launch(args)
    try:
        return _generate(args, dev)
    finally:
        if world > 1:
            mesh.shutdown()


def _generate(args, dev):
    cfg = load_config(args.config, args.cfg_options)
    bundle = build_model_from_cfg(cfg, args.checkpoint, dev)
    # the matching config (configs/gga/gga_kitti_matching.py) names the
    # split to run over + the pseudo-pkl destination; a plain training
    # config falls back to its train info
    matching = cfg.get('matching', {})
    info_path = os.path.join(cfg.data_root,
                             matching.get('info', cfg.data.train_info))
    t0 = time.perf_counter()
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)

    bs = args.batch_size or cfg.data.samples_per_gpu
    tmpdir = args.tmpdir or os.path.join(
        cfg.get('work_dir') or './work_dirs/kitti_GGA', 'eval_parts')
    rank = mesh.rank() if args.rank is None else args.rank
    world = mesh.world_size() if args.world is None else args.world
    detections = run_sharded_inference(bundle, cfg, infos, bs, tmpdir,
                                       rank=rank, world=world)
    if detections is None:
        print(f'rank {rank}: shard dumped, exiting (rank 0 merges and '
              'matches)')
        return dict(rank=rank,
                    scenes=len(shard_indices(len(infos), rank, world)),
                    seconds=time.perf_counter() - t0)
    det_annos = detections_to_kitti_annos(detections, infos,
                                          class_names=CLASSES)
    out = args.out or matching.get('out') or os.path.join(
        cfg.data_root, '..', 'kitti_pseudo',
        'kitti_infos_trainval_GGA_pseudo.pkl')
    pseudo_infos, gt_annos = pseudo_label_matching(infos, det_annos,
                                                   out_path=out)
    seconds = time.perf_counter() - t0
    print(f'pseudo infos -> {out} ({len(pseudo_infos)} scenes, '
          f'{len(infos) / seconds:.2f} scenes/s load through matching)')
    res = dict(infos=len(pseudo_infos), out=out, seconds=seconds,
               scenes_per_s=len(infos) / seconds)
    if args.eval:
        result, ret = kitti_eval(gt_annos, det_annos, list(CLASSES))
        print(result)
        mod = np.mean([ret.get(f'KITTI/{c}_3D_AP11_moderate_strict', 0.0)
                       for c in ('Car',)])
        print(f'Car 3D AP11 moderate: {mod:.2f}')
        res['ap'] = ret
    return res


if __name__ == '__main__':
    main()
