"""The port's stage-4 data path and training CLI against gga_tpu's, CPU.

- ``png.read_png`` against Pillow on hand-written PNGs, one per row filter
  (None, Sub, Up, Average, Paeth) and one mixing all five, in grey, RGB
  and RGBA: the same bytes, and the C++ unfilter equal to its numpy
  oracle; the formats it refuses raise.
- ``KittiMonoDataset`` items and ``epoch_batches`` order against
  gga_tpu's on synthetic KITTI scenes (``tests/test_data/fixtures.py``,
  images by Pillow), exactly, with and without a score filter; the
  ``EpochLoader`` batches of the CLI equal to ``epoch_batches``.
- ``tools/train_pgd.py --tiny --device cpu --batch-size 2 --max-steps 2``
  on 4 scenes: its first loss equal to gga_tpu's loss from the same
  weights and batch at rtol 1e-4, a resume to step 3, the schedule's lr
  at each step, ``tools_lib.evaluate_mono`` on the newest checkpoint, and
  the refusal of fewer infos than a batch.
"""
import json
import os
import pickle
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from gga_tpu.data.kitti import io as kio
from gga_tpu.data.kitti.mono_dataset import KittiMonoDataset as JDataset
from gga_tpu.models.dense_heads import pgd_head as jph
from gga_tpu.models.detectors import pgd as jpgd
from gga_tpu_torch import apis, convert, tools_lib
from gga_tpu_torch.data.dataset import EpochLoader
from gga_tpu_torch.data.kitti import png
from gga_tpu_torch.data.kitti.mono_dataset import KittiMonoDataset
from gga_tpu_torch.models.detectors import pgd as tpgd
from gga_tpu_torch.tools import train_pgd
from gga_tpu_torch.train import checkpoints as ckpt
from gga_tpu_torch.train.optim import step_schedule

from .test_data.fixtures import make_scene, write_kitti_scene

torch.set_num_threads(1)

KINDS = ('none', 'sub', 'up', 'average', 'paeth', 'mixed')


def _chunk(kind, body):
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _png_bytes(img, filters, colour=None, depth=8, interlace=0):
    """An 8-bit PNG of ``img`` [H, W, C] whose row y is filtered with
    ``filters[y % len(filters)]`` (PNG spec section 9)."""
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c] if colour is None else colour
    prev, rows = np.zeros(w * c, np.int64), []
    for y in range(h):
        cur = img[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())
        prev = cur
    return (png.SIGNATURE
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, colour,
                                          0, 0, interlace))
            + _chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + _chunk(b'IEND', b''))


def _image(channels, seed=0, h=13, w=17):
    """Smooth ramps plus noise, so every filter's predictor matters."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (7 * xx + 11 * yy)[..., None] + 40 * np.arange(channels)
    return ((base + rng.randint(0, 60, (h, w, channels))) % 256).astype(
        np.uint8)


@pytest.mark.parametrize('channels', [1, 3, 4], ids=['grey', 'rgb', 'rgba'])
@pytest.mark.parametrize('kind', KINDS)
def test_read_png_matches_pillow(tmp_path, kind, channels):
    filters = (0, 1, 2, 3, 4, 4, 1, 3) if kind == 'mixed' else (
        KINDS.index(kind),)
    path = tmp_path / f'{kind}.png'
    path.write_bytes(_png_bytes(_image(channels), filters))
    ref = np.asarray(Image.open(path).convert('RGB'))
    out = png.read_png(path)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(
        png.decode_png(path.read_bytes(), png.unfilter_numpy), ref)


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    img = _image(3)
    good = _png_bytes(img, (4,))
    cases = dict(
        palette=_png_bytes(img, (0,), colour=3),
        grey_alpha=_png_bytes(_image(2), (0,), colour=4),
        sixteen_bit=_png_bytes(img, (0,), depth=16),
        interlaced=_png_bytes(img, (0,), interlace=1),
        bad_crc=good[:-20] + bytes([good[-20] ^ 1]) + good[-19:],
        bad_filter=_png_bytes(img, (5,)),
        not_png=b'GIF89a' + good[6:])
    for name, data in cases.items():
        with pytest.raises(ValueError):
            png.decode_png(data)
        if name == 'bad_filter':
            with pytest.raises(ValueError):
                png.decode_png(data, png.unfilter_numpy)


@pytest.fixture(scope='module')
def mono_root(tmp_path_factory):
    """Four KITTI scenes of 3 objects (rendered 375 x 1242 images, written
    by Pillow) and their infos with a score on each object."""
    root = str(tmp_path_factory.mktemp('kitti_mono'))
    rng = np.random.RandomState(0)
    boxes = np.array([[12.0, 2.0, -1.7, 3.9, 1.6, 1.55, 0.3],
                      [20.0, -4.0, -1.7, 0.8, 0.6, 1.75, -0.2],
                      [28.0, 6.0, -1.7, 1.76, 0.6, 1.73, 1.0]])
    names = ['Car', 'Pedestrian', 'Cyclist']
    infos = []
    for idx in range(4):
        b = boxes + [0, idx, 0, 0, 0, 0, 0]
        pts = make_scene(rng, b, names, n_ground=1500, n_clutter=100,
                         pts_per_box=150)
        write_kitti_scene(root, idx, pts, b, names)
        info = kio.create_scene_info(root, 'train', idx)
        info['annos']['score'] = rng.uniform(0, 1, len(names))
        infos.append(info)
    info_path = os.path.join(root, 'infos.pkl')
    with open(info_path, 'wb') as f:
        pickle.dump(infos, f)
    return root, info_path


@pytest.mark.parametrize('min_score', [None, 0.5])
def test_mono_dataset_matches_gga_tpu(mono_root, min_score):
    root, info_path = mono_root
    ref = JDataset(root, info_path, max_objs=16, min_score=min_score)
    out = KittiMonoDataset(root, info_path, max_objs=16, min_score=min_score)
    assert len(out) == len(ref) == 4
    n_live = 0
    for i in range(len(ref)):
        r, o = ref[i], out[i]
        assert set(o) == set(r)
        for k in r:
            assert o[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(o[k], r[k], err_msg=f'{i} {k}')
        n_live += int(r['obj_valid'].sum())
    assert 0 < n_live <= 12 and (min_score is None) == (n_live == 12)
    for epoch in range(3):
        for r, o in zip(ref.epoch_batches(3, seed=epoch),
                        out.epoch_batches(3, seed=epoch), strict=True):
            for k in r:
                np.testing.assert_array_equal(o[k], r[k])


@pytest.mark.parametrize('workers', [0, 2])
def test_epoch_loader_gives_the_epoch_batches(mono_root, workers):
    root, info_path = mono_root
    ds = KittiMonoDataset(root, info_path)
    loader = EpochLoader(ds, 2, num_workers=workers)
    for epoch in (0, 1):
        got = list(loader.epoch(epoch))
        want = list(ds.epoch_batches(2, seed=epoch))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def _to_jax_variables(state_dict, cfg):
    """The port's state_dict as gga_tpu's variable trees
    (``convert.pgd_rules`` run backwards)."""
    tree = {'params': {}, 'batch_stats': {}}
    for tk, coll, fp, tr in convert.pgd_rules(cfg):
        v = state_dict[tk].numpy()
        if tr == 'conv2d':                  # OIHW -> HWIO
            v = v.transpose(2, 3, 1, 0)
        node = tree[coll]
        *path, leaf = fp.split('/')
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _jax_loss(variables, batch):
    """gga_tpu's loss of its train step (tools/train_pgd.py:128-143)."""
    cfg = jpgd.PGDModelConfig.tiny()
    model = jpgd.PGDDetector(cfg)
    h, w = batch['image'].shape[1:3]
    fsz = [(h // s, w // s) for s in cfg.head.strides]
    pts = jph.level_points(cfg.head, fsz)
    points = np.concatenate([np.asarray(p) for p in pts])
    strides = np.concatenate([np.full(len(p), s, np.float32)
                              for p, s in zip(pts, cfg.head.strides)])
    ranges = np.concatenate([np.broadcast_to(np.float32(r), (len(p), 2))
                             for p, r in zip(pts, cfg.head.regress_ranges)])

    def loss(v, b):
        targets = jax.vmap(lambda *a: jph.build_targets(
            cfg.head, points, strides, ranges, *a))(
                b['gt_bboxes'], b['gt_labels'], b['gt_cam3d'],
                b['centers2d'], b['depths'], b['obj_valid'])
        (preds, fuse), _ = model.apply(v, b['image'], train=True,
                                       mutable=['batch_stats'])
        return jph.loss(cfg.head, preds, fuse, targets, b['cam2img'],
                        fsz)[0]

    return float(jax.jit(loss)(variables, batch))


def test_train_pgd_cli_matches_gga_tpu_and_resumes(mono_root, tmp_path):
    root, info_path = mono_root
    work = str(tmp_path / 'work')
    argv = ['--tiny', '--device', 'cpu', '--batch-size', '2', '--info',
            info_path, '--data-root', root, '--work-dir', work,
            '--cfg-options', 'log_interval=1']
    first = train_pgd.main(argv + ['--max-steps', '2'])
    assert (first['start_step'], first['end_step']) == (0, 2)
    resumed = train_pgd.main(argv + ['--max-steps', '3', '--resume'])
    assert (resumed['start_step'], resumed['end_step']) == (2, 3)
    assert sorted(os.listdir(os.path.join(work, 'checkpoints'))) == [
        'step_2.pt', 'step_3.pt']             # each epoch's end, the last
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln['step'] for ln in lines] == [1, 2, 3]
    # 4 scenes at batch 2: 2 steps an epoch; gga_pdg.py's optimizer block
    sched = step_schedule(0.001, 2, 500, 1 / 3, (32, 44), 0.1)
    for ln in lines:
        assert ln['lr'] == sched(ln['step'] - 1)
        assert np.isfinite(ln['loss']) and ln['num_pos'] > 0
    assert [ln['epoch'] for ln in lines] == [0, 0, 1]

    # the first step's loss against gga_tpu's from the CLI's initial
    # weights on epoch 0's first batch
    cfg = tpgd.PGDModelConfig.tiny()
    init = apis.init_pgd_trainer(cfg, 2, device='cpu', seed=0).model
    variables = _to_jax_variables(init.state_dict(), cfg)
    batch = next(JDataset(root, info_path).epoch_batches(2, seed=0))
    ref = _jax_loss(variables, batch)
    np.testing.assert_allclose(lines[0]['loss'], ref, rtol=1e-4)

    # the newest checkpoint through evaluate_mono
    bundle = apis.init_pgd_detector(
        cfg, ckpt.load_variables(os.path.join(work, 'checkpoints')),
        device='cpu')
    ev = tools_lib.evaluate_mono(bundle, KittiMonoDataset(root, info_path),
                                 batch_size=3)
    assert set(tools_lib.MONO_AP_KEYS) <= set(ev) and ev['images'] == 4
    assert all(0 <= ev[k] <= 100 for k in tools_lib.MONO_AP_KEYS)

    with pytest.raises(ValueError, match='fewer than one batch'):
        train_pgd.main(['--tiny', '--device', 'cpu', '--batch-size', '5',
                        '--info', info_path, '--data-root', root,
                        '--work-dir', str(tmp_path / 'refused')])
