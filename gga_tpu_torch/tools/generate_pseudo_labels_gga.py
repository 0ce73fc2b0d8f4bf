"""Stage 3: pseudo-3D-label generation on one device (the port's copy of
``tools/generate_pseudo_labels_gga.py``, single process).

Equivalent of the reference's generate_pseudo_labels_gga.py +
KittiDataset_GGA_match.evaluate (kitti_dataset_GGA_match.py:421): run
batched inference over the info split the matching config names (each
batch padded to ``cfg.data.max_points`` points a scene), convert to KITTI
annos, match against the 2D GT by image-plane IoU, dump the pseudo info
pkl, and with ``--eval`` report KITTI AP against the (debug-only) 3D GT.

Without a card the tool raises unless ``--device cpu``.

Usage:
    python -m gga_tpu_torch.tools.generate_pseudo_labels_gga \\
        configs/gga/gga_kitti_matching.py \\
        --checkpoint work_dirs/kitti_GGA/checkpoints [--eval] \\
        [--out PKL] [--batch-size B] [--device cuda|cpu] \\
        [--cfg-options k.ey=val ...]

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
from ..device import resolve_device
from ..eval.kitti_eval import kitti_eval
from ..eval.submission import detections_to_kitti_annos
from ..tools_lib import build_model_from_cfg, run_inference
from .train import load_config

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
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns dict(infos, out, seconds (load through matching),
    scenes_per_s, and with --eval the KITTI AP dict ``ap``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
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
    detections = run_inference(bundle, cfg, infos, bs)
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
