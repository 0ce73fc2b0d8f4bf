"""Stage-4 accuracy evidence: PGD retrained on stage-3 pseudo labels (the
port's copy of ``tools/accuracy_bench_stage4.py``).

Trains the PGD monocular detector (``PGDModelConfig.tiny()``) on the
matched pseudo labels of a weak-trained GGA detector
(``accuracy_bench --dump-pseudo``), or on the stage-1 init labels, then
scores its detections against the synthetic 3D ground truth with the
KITTI evaluator. The scenes get depth-coded point-splat images
(``data/kitti/synth.render_scene_image``), so the monocular detector has
2D -> 3D cues: pixel extent scales with 1 / depth, colour encodes depth
and height.

Every scene is loaded once: the raw RGB images, zero-padded to 384 x
1248, stay on the device as uint8 and are normalized there (BGR, minus
the mean: the padding becomes -mean, as in gga_tpu's bench). The
optimizer is the stage-4 SGD (momentum 0.9, weight decay 1e-4 added to
the gradient, a global-norm clip of 35) on the bench's own schedule
(``lr_schedule``). Batches come in gga_tpu's order (``RandomState(epoch +
1)``, the last partial batch dropped). Without a card the tool raises
unless given ``--device cpu`` (or ``--cpu``).

Usage:
    python -m gga_tpu_torch.tools.accuracy_bench_stage4 --pseudo PSEUDO.pkl \\
        [--steps 3000] [--schedule step] [--eval-every 1000] [--eval-reps 3]
    # without a trained GGA state, on the stage-1 init labels:
    python -m gga_tpu_torch.tools.accuracy_bench_stage4 --pseudo-from stage1
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import pickle
import sys
import time

import numpy as np
import torch

from .. import apis
from ..core import np_geometry as ng
from ..data.kitti import io as kio
from ..data.kitti.mono_dataset import IMG_H, IMG_MEAN, IMG_W, KittiMonoDataset
from ..data.kitti.png import read_png, write_png
from ..data.kitti.synth import IMG_SHAPE, P2, RECT, VELO2CAM, \
    render_scene_image
from ..device import resolve_device
from ..eval.kitti_eval import kitti_eval
from ..eval.submission import mono_detections_to_kitti_annos
from ..models.detectors.pgd import PGDModelConfig
from ..tools_lib import MONO_AP_KEYS
from ..train.loop import TrainState
from ..train.optim import PGDOptimizer
from .accuracy_bench import DEFAULT_ROOT, check_out

CLASSES = ('Pedestrian', 'Cyclist', 'Car')
EVAL_BATCH = 4


def render_images(root, infos):
    """(Re-)render the scenes' point-splat images."""
    for info in infos:
        idx = int(info['image']['image_idx'])
        pts = kio.load_velodyne(
            os.path.join(root, 'training', 'velodyne', f'{idx:06d}.bin'))
        write_png(os.path.join(root, 'training', 'image_2', f'{idx:06d}.png'),
                  render_scene_image(pts))


def stage1_pseudo_infos(infos):
    """Pseudo infos built directly from the stage-1 init pseudo labels
    (the training-free baseline of the retrain stage)."""
    out = []
    for info in infos:
        info = copy.deepcopy(info)
        a = info['annos']
        n = len([x for x in a['name'] if x != 'DontCare'])
        valid = np.asarray(a['GGA_mask_valid'], bool)[:n]
        init = np.asarray(a['GGA_init_pseudo_label'],
                          np.float64)[:n][valid].copy()
        init[:, 2] -= init[:, 5] / 2  # gravity -> bottom center (lidar)
        names = np.asarray(a['name'])[:n][valid]
        cam = ng.box_lidar_to_camera(init, RECT, VELO2CAM)
        bbox = ng.boxes3d_to_image_bbox(cam, P2, IMG_SHAPE)
        info['annos'] = dict(
            name=names,
            truncated=np.zeros(len(names)),
            occluded=np.zeros(len(names), np.int64),
            alpha=cam[:, 6] - np.arctan2(cam[:, 0], cam[:, 2]),
            bbox=bbox,
            dimensions=cam[:, 3:6],
            location=cam[:, :3],
            rotation_y=cam[:, 6],
            score=np.ones(len(names)),
        )
        out.append(info)
    return out


def stack_dataset(ds, device):
    """Every item of a ``KittiMonoDataset`` stacked on ``device``: the
    object fields as the dataset gives them, and ``image_u8``, the raw RGB
    images zero-padded to IMG_H x IMG_W (uint8, normalized per batch by
    ``normalize_images``)."""
    items = [{k: v for k, v in ds[i].items() if k != 'image'}
             for i in range(len(ds))]
    out = {k: torch.from_numpy(np.stack([it[k] for it in items])).to(device)
           for k in items[0]}
    raw = np.zeros((len(ds), IMG_H, IMG_W, 3), np.uint8)
    for i, info in enumerate(ds.infos):
        img = read_png(os.path.join(ds.root, info['image']['image_path']))
        h, w = min(img.shape[0], IMG_H), min(img.shape[1], IMG_W)
        raw[i, :h, :w] = img[:h, :w]
    out['image_u8'] = torch.from_numpy(raw).to(device)
    return out


def normalize_images(u8):
    """``KittiMonoDataset``'s caffe normalization on the device: RGB ->
    BGR, minus the BGR mean, [B, H, W, 3] f32 (the zero padding becomes
    -mean)."""
    return u8.flip(-1).float() - torch.from_numpy(IMG_MEAN).to(u8.device)


def lr_schedule(lr, steps, schedule='step'):
    """The bench's lr as a function of the step (gga_tpu's optax schedule,
    ``tools/accuracy_bench_stage4.py:328-346``, in float64): a linear
    warmup over ``min(500, steps // 4)`` steps from ``lr / 3`` to ``lr``,
    then ``lr``; with ``schedule='step'`` x0.1 from step ``d1 = max(warmup
    + 1, int(steps * 32 / 48))`` and x0.01 from ``d2 = max(d1 + 1,
    int(steps * 44 / 48))`` (absolute steps, the reference's epoch
    fractions)."""
    if schedule not in ('step', 'flat'):
        raise ValueError(f'schedule {schedule!r}: step or flat')
    warmup = min(500, steps // 4)
    bounds = ()
    if schedule == 'step':
        d1 = max(warmup + 1, int(steps * 32 / 48))
        bounds = (d1, max(d1 + 1, int(steps * 44 / 48)))

    def sched(step):
        if step < warmup:
            return (lr / 3 - lr) * (1 - max(step, 0) / warmup) + lr
        return lr * 0.1 ** sum(step >= b for b in bounds)

    return sched


def evaluate_pgd(bundle, ds_dev, n, infos):
    """PGD inference over all scenes -> KITTI AP against the synthetic
    ground truth: ``apis.infer_mono`` on batches of EVAL_BATCH (the last
    one padded with the last scene), then the five metrics of
    ``tools_lib.MONO_AP_KEYS``."""
    detections = []
    for i in range(0, n, EVAL_BATCH):
        idx = torch.from_numpy(np.minimum(np.arange(i, i + EVAL_BATCH),
                                          n - 1)).to(bundle.device)
        out = apis.infer_mono(bundle,
                              normalize_images(ds_dev['image_u8'][idx]),
                              ds_dev['cam2img'][idx])
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for j in range(min(EVAL_BATCH, n - i)):
            v = out['valid'][j]
            detections.append(dict(
                boxes_cam=out['boxes'][j][v], scores=out['scores'][j][v],
                labels=out['labels'][j][v], bboxes2d=out['bboxes2d'][j][v]))
    det_annos = mono_detections_to_kitti_annos(detections, infos,
                                               class_names=CLASSES)
    _, m = kitti_eval([info['annos'] for info in infos], det_annos, ['Car'],
                      eval_types=('bbox', 'bev', '3d'))
    return {name: m.get(key, 0.0) for name, key in MONO_AP_KEYS.items()}


def score_pseudo_vs_gt(pseudo_infos, infos):
    """AP of the (stage-3) pseudo labels themselves: the quality of the
    retraining data, the natural reference point of stage 4."""
    det_annos = []
    for p in pseudo_infos:
        a = {k: np.asarray(v) for k, v in p['annos'].items()
             if not k.startswith('GGA') and k != 'num_points_in_gt'}
        if 'score' not in a or len(a['score']) != len(a['name']):
            a['score'] = np.ones(len(a['name']))
        det_annos.append(a)
    _, m = kitti_eval([info['annos'] for info in infos], det_annos, ['Car'],
                      eval_types=('bbox', 'bev', '3d'))
    return {name: m.get(MONO_AP_KEYS[name], 0.0)
            for name in ('AP11_3D_mod', 'AP11_3D_mod_loose',
                         'AP11_BEV_mod_loose')}


def epoch_order(n_scenes, batch, epoch):
    """The scene indices of each batch of an epoch: ``RandomState(epoch +
    1)`` order, the last partial batch dropped."""
    order = np.arange(n_scenes)
    np.random.RandomState(epoch + 1).shuffle(order)
    n_full = n_scenes // batch * batch
    return [order[i:i + batch] for i in range(0, n_full, batch)]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=DEFAULT_ROOT)
    ap.add_argument('--pseudo', default=None,
                    help='stage-3 pseudo infos pkl (accuracy_bench '
                         '--dump-pseudo output)')
    ap.add_argument('--pseudo-from', default=None, choices=['stage1'],
                    help='build pseudo labels from the stage-1 init labels '
                         'instead of a trained detector')
    ap.add_argument('--steps', type=int, default=3000)
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--lr', type=float, default=2e-3)
    ap.add_argument('--schedule', default='step', choices=['flat', 'step'],
                    help="'step': x0.1 at 32/48 and 44/48 of the steps "
                         "(the reference PGD retrain); 'flat': lr after "
                         'the warmup')
    ap.add_argument('--ema', type=float, default=0.0,
                    help='EMA decay of the eval weights (0 disables); '
                         'evals then also report the raw weights as *_raw')
    ap.add_argument('--eval-every', type=int, default=0)
    ap.add_argument('--eval-reps', type=int, default=1,
                    help='repeat the final eval this many times on the '
                         'same weights')
    ap.add_argument('--out', default=None)
    ap.add_argument('--cpu', action='store_true',
                    help='the same as --device cpu')
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = 'cpu'
    return args


def main(argv=None):
    """Returns the result dict (gga_tpu's keys, plus the train wall
    seconds), or 1 when the root holds no scenes."""
    args = parse_args(argv)
    check_out(args.out)
    dev = resolve_device(args.device)

    info_path = os.path.join(args.root, 'kitti_infos_train_GGA.pkl')
    if not os.path.exists(info_path):
        print(f'no scenes at {args.root}; run gga_tpu_torch.tools.'
              'accuracy_bench first (it generates them)', file=sys.stderr)
        return 1
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)

    print(f'[1/4] rendering {len(infos)} scene images...')
    render_images(args.root, infos)

    if args.pseudo:
        with open(args.pseudo, 'rb') as f:
            pseudo_infos = pickle.load(f)
        pseudo_src = args.pseudo
    else:
        print('[1.5/4] building stage-1 init pseudo labels...')
        pseudo_infos = stage1_pseudo_infos(infos)
        pseudo_src = 'stage1'
    pseudo_path = os.path.join(args.root, 'kitti_infos_pseudo_mono.pkl')
    with open(pseudo_path, 'wb') as f:
        pickle.dump(pseudo_infos, f)

    data_quality = score_pseudo_vs_gt(pseudo_infos, infos)
    print('  pseudo-label (training data) quality:',
          json.dumps(data_quality))

    cfg = PGDModelConfig.tiny()
    ds = KittiMonoDataset(args.root, pseudo_path, max_objs=16)
    n_scenes = len(ds)
    if n_scenes < args.batch:
        raise ValueError(f'{n_scenes} scenes, fewer than one batch of '
                         f'{args.batch}: an epoch would train no step')
    print(f'  loading {n_scenes} scenes onto {dev}...')
    ds_dev = stack_dataset(ds, dev)
    bundle = apis.init_pgd_detector(cfg, device=dev, seed=0)
    model = bundle.model
    print(f'  PGD tiny params: '
          f'{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M')

    def evaluate(ema):
        """AP of the eval weights (the EMA's, if any) and of the raw
        weights as *_raw beside them."""
        if ema is None:
            return evaluate_pgd(bundle, ds_dev, n_scenes, infos)
        averaged = copy.deepcopy(model)
        averaged.load_state_dict(ema, strict=False)
        res = evaluate_pgd(apis.DetectorBundle(averaged, cfg, dev), ds_dev,
                           n_scenes, infos)
        raw = evaluate_pgd(bundle, ds_dev, n_scenes, infos)
        res.update({f'{k}_raw': v for k, v in raw.items()})
        return res

    print('[2/4] scoring UNTRAINED PGD...')
    before = evaluate(None)
    print('  untrained:', json.dumps(before))

    trainer = TrainState(
        model=model.train(),
        optimizer=PGDOptimizer(model.parameters(),
                               lr_schedule(args.lr, args.steps,
                                           args.schedule),
                               momentum=0.9, weight_decay=1e-4,
                               grad_clip=35.0),
        step=0, generator=torch.Generator().manual_seed(0))
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if args.ema else None)

    print(f'[3/4] training PGD {args.steps} steps '
          f'on {pseudo_src} pseudo labels...')
    t0 = time.perf_counter()
    step, epoch, curve, eval_train_s = 0, 0, [], 0.0
    while step < args.steps:
        for idx in epoch_order(n_scenes, args.batch, epoch):
            idx = torch.from_numpy(idx).to(dev)
            batch = {k: v[idx] for k, v in ds_dev.items()
                     if k != 'image_u8'}
            batch['image'] = normalize_images(ds_dev['image_u8'][idx])
            logs = apis.pgd_train_step(trainer, batch)
            if ema is not None:
                with torch.no_grad():
                    for n, p in model.named_parameters():
                        ema[n].mul_(args.ema).add_(p.detach(),
                                                   alpha=1 - args.ema)
            step += 1
            if step % 50 == 0 or step == 1:
                print(f'  step {step}: loss={float(logs["loss"]):.3f}')
            if args.eval_every and step % args.eval_every == 0 \
                    and step < args.steps:
                t_eval = time.perf_counter()
                mid = evaluate(ema)
                eval_train_s += time.perf_counter() - t_eval
                curve.append(dict(step=step, **mid))
                print(f'  [curve] step {step}: {json.dumps(mid)}')
            if step >= args.steps:
                break
        epoch += 1
    if step:
        float(logs['loss'])                 # the last step is done
    train_s = time.perf_counter() - t0 - eval_train_s
    print(f'  trained {step} steps in {train_s:.0f}s')

    print('[4/4] scoring TRAINED PGD vs synthetic GT...')
    reps = []
    for rep in range(max(args.eval_reps - 1, 0)):
        reps.append(evaluate(ema))
        print(f'  [eval-rep {rep}]: {json.dumps(reps[-1])}')
    after = evaluate(ema)
    print('  trained:', json.dumps(after))
    curve.append(dict(step=step, **after))

    result = {
        'metric': 'synthetic_kitti_stage4_pgd_AP11_3D_moderate',
        'pseudo_source': pseudo_src,
        'pseudo_data_quality': data_quality,
        'untrained': before, 'trained': after, 'curve': curve,
        'scenes': len(infos), 'train_steps': step,
        'schedule': args.schedule, 'ema': args.ema, 'lr': args.lr,
        'eval_reps': reps, 'device': str(dev), 'train_s': train_s,
    }
    print(json.dumps(result))
    if args.out:
        with open(args.out, 'w') as f:
            f.write('# Stage 4 (gga_tpu_torch): PGD retrained on pseudo '
                    'labels\n\n')
            f.write(f'- pseudo source: {pseudo_src}\n')
            f.write(f'- training-data quality: '
                    f'{json.dumps(data_quality)}\n')
            f.write(f'- untrained PGD: {json.dumps(before)}\n')
            f.write(f'- trained PGD:   {json.dumps(after)}\n')
    return result


if __name__ == '__main__':
    main()
