"""Evaluation and submission files on one device (the port's copy of
``tools/test.py``).

Runs inference over an info split (batched, each batch padded to
``cfg.data.max_points`` points a scene; or, with ``--aug-test``, scene by
scene through ``apis.aug_inference_detector``: three scales times a
horizontal flip, merged by a per-class rotated-BEV NMS), converts the
detections to KITTI annos, writes KITTI submission txt files
(``--format-only`` / ``--submission-dir``) and with ``--eval`` reports
KITTI AP against the split's annos. One process, no mesh. Without a card
the tool raises unless ``--device cpu``.

Usage:
    python -m gga_tpu_torch.tools.test configs/gga/gga_kitti.py \\
        --checkpoint work_dirs/kitti_GGA/checkpoints \\
        [--info kitti_infos_val_GGA.pkl] [--eval] \\
        [--format-only --submission-dir out/] [--batch-size B] \\
        [--aug-test] [--device cuda|cpu] [--cfg-options k.ey=val ...]
"""
from __future__ import annotations

import argparse
import time

from .. import apis
from ..data import pipelines as pl
from ..device import resolve_device
from ..eval.kitti_eval import kitti_eval
from ..eval.submission import (detections_to_kitti_annos,
                               write_kitti_submission)
from ..tools_lib import build_model_from_cfg, load_infos, run_inference
from .train import load_config

CLASSES = ('Pedestrian', 'Cyclist', 'Car')


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('config')
    p.add_argument('--checkpoint', required=True,
                   help='checkpoint dir; its newest checkpoint is loaded')
    p.add_argument('--info', default=None,
                   help='info pkl name under data_root (default: '
                        'cfg.data.train_info)')
    p.add_argument('--eval', action='store_true')
    p.add_argument('--format-only', action='store_true')
    p.add_argument('--submission-dir', default=None)
    p.add_argument('--batch-size', type=int, default=None)
    p.add_argument('--aug-test', action='store_true',
                   help='multi-scale + flip test-time augmentation, scene '
                        'by scene')
    p.add_argument('--device', default='cuda')
    p.add_argument('--cfg-options', nargs='*', default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Returns dict(scenes, detections, seconds (inference through the
    annos), scenes_per_s, submission_dir (None without one), and with
    --eval the KITTI AP dict ``ap``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config, args.cfg_options)
    bundle = build_model_from_cfg(cfg, args.checkpoint, dev)
    infos = load_infos(cfg, args.info or cfg.data.train_info)

    t0 = time.perf_counter()
    if args.aug_test:
        detections = []
        for i, info in enumerate(infos):
            s = pl.load_sample(info, cfg.data_root,
                               pts_prefix=cfg.data.pts_prefix)
            detections.append(apis.aug_inference_detector((bundle, cfg),
                                                          s['points']))
            if i % 50 == 0:
                print(f'  aug-test {i + 1}/{len(infos)}')
    else:
        bs = args.batch_size or cfg.data.samples_per_gpu
        detections = run_inference(bundle, cfg, infos, bs)
    det_annos = detections_to_kitti_annos(detections, infos,
                                          class_names=CLASSES)
    seconds = time.perf_counter() - t0
    res = dict(scenes=len(infos),
               detections=sum(len(a['name']) for a in det_annos),
               seconds=seconds, scenes_per_s=len(infos) / seconds,
               submission_dir=None)

    if args.format_only or args.submission_dir:
        out = args.submission_dir or 'submission'
        write_kitti_submission(det_annos, infos, out)
        print(f'submission files -> {out}')
        res['submission_dir'] = out
    if args.eval:
        gt_annos = [info['annos'] for info in infos]
        result, ret = kitti_eval(gt_annos, det_annos, list(CLASSES))
        print(result)
        res['ap'] = ret
    return res


if __name__ == '__main__':
    main()
