"""Accuracy evidence for the GGA weak-supervision pipeline (the port's copy
of ``tools/accuracy_bench.py``).

Runs the weak-supervision loop on a learnable synthetic mini-KITTI
(consistent 3D boxes, 2D projections and surface point clusters,
``data/kitti/synth.py``):

  1. stage-1 weak labels from the real generator (RANSAC ground, region
     grow, rotating calipers: ``data/kitti/gga_labels.py``);
  2. stage-2 weak training of the GGA detector (``GGAModelConfig.small()``
     by default) on those labels, never the 3D ground truth;
  3. stage-3 pseudo labels through the real decode and the image-IoU
     matcher (``data/kitti/pseudo_labels.py``);
  4. the pseudo labels scored against the synthetic 3D ground truth by
     the KITTI evaluator: AP11 of Car, moderate, 3D and BEV, at 0.7
     (strict) and 0.5 (loose) IoU.

The scenes, labels, batch order, optimizer and evaluation are gga_tpu's;
the initial weights come from ``torch.Generator(0)``. ``--save-state`` /
``--load-state`` are ``torch.save`` files of the detector's state_dict
(gga_tpu pickles JAX arrays, which need JAX to read). The
``--dump-pseudo`` pickle holds numpy only, with gga_tpu's keys, so either
package's stage-4 bench reads it. Without a card the tool raises unless
given ``--device cpu`` (or ``--cpu``).

Usage:
    python -m gga_tpu_torch.tools.accuracy_bench --scenes 96 --steps 2000 \\
        --lr 2e-4 --flat-lr --pal --dim-prior 3.0 --yaw-prior 1.0 \\
        --containment 1.0 --eval-every 500 --dump-pseudo PSEUDO.pkl
    # on the CPU, the small model:
    python -m gga_tpu_torch.tools.accuracy_bench --device cpu --cfg tiny \\
        --scenes 8 --steps 2 --batch 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import apis
from ..data.dataset import EpochLoader, KittiGGADataset
from ..data.kitti import io as kio
from ..data.kitti.gga_labels import calculate_gga_labels
from ..data.kitti.gt_database import create_reduced_point_clouds
from ..data.kitti.pseudo_labels import pseudo_label_matching
from ..data.kitti.synth import make_scene, write_kitti_scene
from ..device import resolve_device
from ..eval.kitti_eval import kitti_eval
from ..eval.submission import detections_to_kitti_annos
from ..models.detectors.centerpoint_gga import GGAModelConfig

CLASSES = ('Pedestrian', 'Cyclist', 'Car')
# the bench's metrics: name -> kitti_eval key
AP_KEYS = dict(
    AP11_3D_mod='KITTI/Car_3D_AP11_moderate_strict',
    AP11_BEV_mod='KITTI/Car_BEV_AP11_moderate_strict',
    AP11_3D_mod_loose='KITTI/Car_3D_AP11_moderate_loose',
    AP11_BEV_mod_loose='KITTI/Car_BEV_AP11_moderate_loose')
EVAL_BATCH = 8
MAX_POINTS = 8192
DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), 'gga_accuracy_kitti')
# gga_tpu's records of its own runs, which the port's --out never replaces
_RECORDS = tuple(Path(__file__).resolve().parents[2] / name
                 for name in ('ACCURACY.md', 'ACCURACY_stage4.md'))


def check_out(path):
    """Raise if ``path`` is one of gga_tpu's accuracy records."""
    if path and Path(path).resolve() in _RECORDS:
        raise ValueError(f'--out {path}: that file records gga_tpu\'s runs; '
                         'write the port\'s report elsewhere')


def make_synth_kitti(root, n_scenes, seed=0):
    """Scenes with 1-5 cars (+ 0-2 pedestrians) in the camera frustum,
    surface-ish point clusters, written as real KITTI files with their
    stage-1 labels. Returns (infos, info pkl path)."""
    rng = np.random.RandomState(seed)
    infos = []
    for idx in range(n_scenes):
        n_car = rng.randint(1, 6)
        n_ped = rng.randint(0, 3)
        boxes, names = [], []
        for _ in range(n_car + n_ped):
            is_car = len(boxes) < n_car
            for _try in range(30):
                x = rng.uniform(8, 52)
                y = rng.uniform(-0.32, 0.32) * x
                if all(abs(x - b[0]) > 5 or abs(y - b[1]) > 4
                       for b in boxes):
                    break
            if is_car:
                dims = [rng.uniform(3.4, 4.6), rng.uniform(1.5, 1.85),
                        rng.uniform(1.4, 1.7)]
            else:
                dims = [rng.uniform(0.5, 0.9), rng.uniform(0.5, 0.8),
                        rng.uniform(1.6, 1.85)]
            yaw = rng.uniform(-np.pi, np.pi)
            boxes.append([x, y, -1.73, dims[0], dims[1], dims[2], yaw])
            names.append('Car' if is_car else 'Pedestrian')
        boxes = np.array(boxes, np.float64)
        pts = make_scene(rng, boxes, names, n_ground=6000, n_clutter=400,
                         pts_per_box=350)
        write_kitti_scene(root, idx, pts, boxes, names)
        info = kio.create_scene_info(root, 'train', idx)
        kio.compute_num_points_in_gt(root, info)
        calculate_gga_labels(
            kio.load_velodyne(f'{root}/training/velodyne/{idx:06d}.bin'),
            info, rng=np.random.RandomState(1000 + idx))
        infos.append(info)
    create_reduced_point_clouds(root, infos)
    info_path = os.path.join(root, 'kitti_infos_train_GGA.pkl')
    with open(info_path, 'wb') as f:
        pickle.dump(infos, f)
    return infos, info_path


def _ap(metrics):
    return {name: metrics.get(key, 0.0) for name, key in AP_KEYS.items()}


def evaluate_pseudo(bundle, ds_test, infos, dump_path=None):
    """decode -> KITTI annos -> pseudo-label matching -> KITTI AP.

    ``apis.infer`` on batches of EVAL_BATCH scenes of the test view's
    first ``MAX_POINTS`` points (in eval mode). Detections are ranked by
    their heatmap LOGITS: weak-trained heatmaps saturate the sigmoid at
    exactly 1.0, and AP depends only on the order of the scores, which
    the logits keep. With ``dump_path`` the matched pseudo infos are
    pickled there."""
    bundle.model.eval()
    detections = []
    n = len(infos)
    P = ds_test.shapes[0]
    for i in range(0, n, EVAL_BATCH):
        pts_b = np.zeros((EVAL_BATCH, P, 4), np.float32)
        val_b = np.zeros((EVAL_BATCH, P), bool)
        for j in range(min(EVAL_BATCH, n - i)):
            p = ds_test.get_sample(i + j)['points'][:P]
            pts_b[j, :len(p)] = p[:, :4]
            val_b[j, :len(p)] = True
        out = {k: v.cpu().numpy()
               for k, v in apis.infer(bundle, pts_b, val_b).items()}
        for j in range(min(EVAL_BATCH, n - i)):
            v = out['valid'][j]
            detections.append(dict(boxes_3d=out['boxes'][j][v],
                                   scores_3d=out['logits'][j][v],
                                   labels_3d=out['labels'][j][v]))
    det_annos = detections_to_kitti_annos(detections, infos,
                                          class_names=CLASSES)
    pseudo_infos, gt_annos = pseudo_label_matching(infos, det_annos)
    if dump_path:
        with open(dump_path, 'wb') as f:
            pickle.dump(pseudo_infos, f)
    _, metrics = kitti_eval(gt_annos, [i['annos'] for i in pseudo_infos],
                            ['Car'], eval_types=('bbox', 'bev', '3d'))
    return _ap(metrics)


def score_stage1_labels(infos):
    """KITTI AP of the stage-1 init pseudo labels themselves against the
    ground truth: the weak-label generator's quality, training-free. The
    init pseudo z is a gravity centre (``gga_labels`` stage 4); it is
    moved to the bottom before the submission converter."""
    dets = []
    for info in infos:
        a = info['annos']
        n = len([x for x in a['name'] if x != 'DontCare'])
        valid = np.asarray(a['GGA_mask_valid'], bool)[:n]
        init = np.asarray(a['GGA_init_pseudo_label'],
                          np.float64)[:n][valid].copy()
        init[:, 2] -= init[:, 5] / 2
        labels = np.array([CLASSES.index(nm)
                           for nm in np.asarray(a['name'])[:n][valid]])
        dets.append(dict(boxes_3d=init, scores_3d=np.ones(len(init)),
                         labels_3d=labels))
    det_annos = detections_to_kitti_annos(dets, infos, class_names=CLASSES)
    _, m = kitti_eval([info['annos'] for info in infos], det_annos, ['Car'],
                      eval_types=('bbox', 'bev', '3d'))
    return _ap(m)


def bench_config(cfg: GGAModelConfig, budget_scale=1.0, pal=False,
                 dim_prior=0.0, yaw_prior=0.0, containment=0.0):
    """``cfg`` with the bench's options: the sparse budgets scaled by
    ``budget_scale`` (at least 256), and the head's PAL backprop and
    dim-prior, yaw-prior and containment loss weights."""
    if budget_scale != 1.0:
        s = budget_scale
        cfg = dataclasses.replace(
            cfg,
            max_voxels=max(256, int(cfg.max_voxels * s)),
            encoder_budgets=tuple(max(256, int(b * s))
                                  for b in cfg.encoder_budgets),
            encoder_out_budget=max(256, int(cfg.encoder_out_budget * s)))
    head_kw = {}
    if pal:
        head_kw['pal_in_total_loss'] = True
    if dim_prior > 0.0:
        head_kw['task_dim_priors'] = cfg.task_dim_priors
        head_kw['loss_dim_prior_weight'] = dim_prior
    if yaw_prior > 0.0:
        head_kw['loss_yaw_prior_weight'] = yaw_prior
    if containment > 0.0:
        head_kw['loss_containment_weight'] = containment
    if head_kw:
        cfg = dataclasses.replace(
            cfg, head=dataclasses.replace(cfg.head, **head_kw))
    return cfg


def datasets(root, info_path, cfg):
    """The train view (``MAX_POINTS`` points, the head's objects, 128
    cluster points, no database sampling) and the test view of the
    scenes."""
    kw = dict(max_points=MAX_POINTS, max_objs=cfg.head.max_objs,
              max_cluster_pts=128, pc_range=cfg.point_cloud_range)
    return (KittiGGADataset(root, info_path, **kw),
            KittiGGADataset(root, info_path, test_mode=True, **kw))


def weak_batches(ds, batch_size):
    """gga_tpu's batches, epoch after epoch: epoch e in
    ``RandomState(e + 1)`` order, the last partial batch dropped, loaded
    in this process. Yields (epoch, batch)."""
    if len(ds) < batch_size:
        raise ValueError(f'{len(ds)} scenes, fewer than one batch of '
                         f'{batch_size}: an epoch would train no step')
    loader = EpochLoader(ds, batch_size, seed=1)
    epoch = 0
    while True:
        for batch in loader.epoch(epoch):
            yield epoch, batch
        epoch += 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--scenes', type=int, default=48)
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--lr', type=float, default=2e-4,
                    help='base lr (cyclic peak = 10x)')
    ap.add_argument('--root', default=DEFAULT_ROOT)
    ap.add_argument('--out', default=None,
                    help='write a markdown report here')
    ap.add_argument('--cpu', action='store_true',
                    help='the same as --device cpu')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--eval-every', type=int, default=0,
                    help='also score pseudo labels every N steps '
                         '(the AP-vs-steps curve)')
    ap.add_argument('--flat-lr', action='store_true',
                    help='constant lr and beta1 instead of the cyclic '
                         'schedules')
    ap.add_argument('--save-state', default=None,
                    help='torch.save the trained state_dict here')
    ap.add_argument('--load-state', default=None,
                    help='skip training, evaluate this saved state_dict')
    ap.add_argument('--dump-pseudo', default=None,
                    help='pickle the final matched pseudo infos here '
                         '(stage-3 output; feeds the stage-4 bench)')
    ap.add_argument('--pal', action='store_true',
                    help='backprop the PAL point-to-box terms (the '
                         'reference computes them but leaves them out of '
                         'its total loss)')
    ap.add_argument('--dim-prior', type=float, default=0.0,
                    help='weight of the class-prior dim anchor loss')
    ap.add_argument('--yaw-prior', type=float, default=0.0,
                    help='weight of the init-pseudo yaw anchor loss')
    ap.add_argument('--containment', type=float, default=0.0,
                    help='weight of the cluster-containment residual')
    ap.add_argument('--budget-scale', type=float, default=1.0,
                    help='scale the sparse voxel / stage budgets (< 1 '
                         'forces truncation)')
    ap.add_argument('--cfg', default='small', choices=['small', 'tiny'],
                    help='model variant; "small" keeps every voxel of an '
                         '8k-point scene')
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = 'cpu'
    return args


def main(argv=None):
    """Returns the result dict (gga_tpu's keys, plus the train and eval
    wall seconds)."""
    args = parse_args(argv)
    check_out(args.out)
    dev = resolve_device(args.device)

    print(f'[1/4] generating {args.scenes} synthetic scenes...')
    info_path = os.path.join(args.root, 'kitti_infos_train_GGA.pkl')
    infos = None
    if os.path.exists(info_path):
        with open(info_path, 'rb') as f:
            infos = pickle.load(f)
    if infos is None or len(infos) != args.scenes:
        infos, info_path = make_synth_kitti(args.root, args.scenes)

    cfg = bench_config(getattr(GGAModelConfig, args.cfg)(),
                       args.budget_scale, args.pal, args.dim_prior,
                       args.yaw_prior, args.containment)
    ds, ds_test = datasets(args.root, info_path, cfg)
    trainer = apis.init_trainer(cfg, args.steps, device=dev, seed=0,
                                optimizer=dict(lr=args.lr,
                                               cyclic=not args.flat_lr))
    bundle = apis.DetectorBundle(trainer.model, cfg, dev)
    eval_s = []

    def evaluate(dump_path=None):
        t0 = time.perf_counter()
        res = evaluate_pseudo(bundle, ds_test, infos, dump_path)
        eval_s.append(time.perf_counter() - t0)
        return res

    print('[1.5/4] scoring STAGE-1 init pseudo labels...')
    stage1 = score_stage1_labels(infos)
    print('  stage-1 labels:', json.dumps(stage1))

    print('[2/4] scoring UNTRAINED pseudo labels...')
    before = evaluate()
    print('  untrained:', json.dumps(before))

    if args.load_state:
        trainer.model.load_state_dict(torch.load(args.load_state,
                                                 map_location=dev))
        after = evaluate(args.dump_pseudo)
        print('  loaded-state:', json.dumps(after))
        return dict(trained=after, stage1_labels=stage1)

    print(f'[3/4] weak-training {args.steps} steps...')
    t0 = time.perf_counter()
    step, curve, eval_train_s = 0, [], 0.0
    batches = weak_batches(ds, args.batch)
    while step < args.steps:
        _, batch = next(batches)
        logs = apis.train_step(trainer, batch)
        step += 1
        if step % 50 == 0 or step == 1:
            print(f'  step {step}: loss={float(logs["loss"]):.3f} '
                  f'heatmap={float(logs["task0.loss_heatmap"]):.3f}')
        if args.eval_every and step % args.eval_every == 0 \
                and step < args.steps:
            mid = evaluate()
            eval_train_s += eval_s[-1]
            curve.append(dict(step=step, **mid))
            print(f'  [curve] step {step}: {json.dumps(mid)}')
    if step:
        float(logs['loss'])                 # the last step is done
    train_s = time.perf_counter() - t0 - eval_train_s
    print(f'  trained {step} steps in {train_s:.0f}s')

    print('[4/4] scoring TRAINED pseudo labels...')
    if args.save_state:
        torch.save(trainer.model.state_dict(), args.save_state)
    after = evaluate(args.dump_pseudo)
    print('  trained:', json.dumps(after))

    curve.append(dict(step=step, **after))
    result = {
        'metric': 'synthetic_kitti_pseudo_label_AP11_3D_moderate',
        'stage1_labels': stage1,
        'untrained': before, 'trained': after, 'curve': curve,
        'scenes': args.scenes, 'train_steps': step, 'cfg': args.cfg,
        'pal': args.pal, 'device': str(dev), 'train_s': train_s,
        'eval_s': eval_s,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, 'w') as f:
            f.write('# Synthetic-KITTI pseudo-label AP (gga_tpu_torch)\n\n')
            f.write('Weak-supervision loop on a learnable synthetic '
                    'mini-KITTI\n(gga_tpu_torch/tools/accuracy_bench.py): '
                    'stage-1 weak labels -> GGA weak\ntraining -> '
                    'pseudo-label matching -> KITTI eval vs synthetic 3D '
                    'GT.\n\n')
            f.write(f'- scenes: {args.scenes}, train steps: {step}, '
                    f'cfg: {args.cfg}, device: {dev}\n')
            f.write(f'- stage-1 labels (generator quality): '
                    f'{json.dumps(stage1)}\n')
            f.write(f'- untrained: {json.dumps(before)}\n')
            f.write(f'- trained:   {json.dumps(after)}\n')
            if len(curve) > 1:
                f.write('\nAP-vs-steps curve (3D strict moderate):\n\n')
                f.write('| step | 3D strict | 3D loose | BEV loose |\n')
                f.write('|---|---|---|---|\n')
                for c in curve:
                    f.write(f"| {c['step']} | {c['AP11_3D_mod']:.2f} | "
                            f"{c['AP11_3D_mod_loose']:.2f} | "
                            f"{c['AP11_BEV_mod_loose']:.2f} |\n")
    return result


if __name__ == '__main__':
    main()
