"""The port's segmentation datasets and ``seg_eval`` against gga_tpu's:

- ``S3DISSegDataset`` (with and without patch sampling, test mode),
  ``ScanNetSegDataset`` (nyu40 ids mapped to the 20 classes, 20 for the
  rest, xyz only too) and ``SemanticKITTIDataset`` (the learning map, 255
  for unlabelled, instance bits ignored), on synthetic fixtures written
  as gga_tpu's ``tests/test_data/test_seg_datasets.py`` writes them, and
  S3DIS on the port's stage 1 of ``test_torch_indoor_converter
  .write_s3dis``: the same seed gives the same samples, sample for
  sample, and the same ``epoch_batches``;
- ``seg_eval`` and ``instance_seg_eval``: equal dicts, NaNs included.
"""
import os
import pickle

import numpy as np
import pytest

from gga_tpu.data import seg_datasets as jsd
from gga_tpu.eval import seg_eval as jse
from gga_tpu_torch.data import seg_datasets as tsd
from gga_tpu_torch.eval import seg_eval as tse
from gga_tpu_torch.tools import create_data
from tests.test_torch_indoor_converter import write_s3dis


def _write(root, name, n, dims, mask_dtype, rng, raw_ids=None):
    pts = rng.rand(n, dims).astype(np.float32)
    pts[:, :3] *= 4
    pts.tofile(os.path.join(root, f'{name}.bin'))
    ids = raw_ids if raw_ids is not None else np.arange(13)
    rng.choice(ids, n).astype(mask_dtype).tofile(
        os.path.join(root, f'{name}_sem.bin'))
    rng.randint(0, 20, n).astype(np.int64).tofile(
        os.path.join(root, f'{name}_inst.bin'))
    return dict(pts_path=f'{name}.bin',
                pts_semantic_mask_path=f'{name}_sem.bin',
                pts_instance_mask_path=f'{name}_inst.bin')


def _fixture(root, kind):
    """Four scenes of 300-700 points (one below ``num_points``) and their
    info pkl, as gga_tpu's dataset tests write them."""
    rng = np.random.RandomState(7)
    if kind == 'semantickitti':
        dims, dtype = 4, np.uint32
        ids = np.array(sorted(jsd.SEMKITTI_LEARNING_MAP), np.uint32)
        ids = np.concatenate([ids, ids | np.uint32(5 << 16)])
    elif kind == 'scannet':
        dims, dtype, ids = 6, np.int64, np.arange(0, 45)
    else:
        dims, dtype, ids = 6, np.int64, None
    infos = [_write(root, f's{i}', n, dims, dtype, rng, ids)
             for i, n in enumerate((500, 700, 200, 640))]
    with open(os.path.join(root, 'infos.pkl'), 'wb') as f:
        pickle.dump(infos, f)
    return os.path.join(root, 'infos.pkl')


CASES = {
    's3dis': ('S3DISSegDataset', dict(num_points=256)),
    's3dis-patch': ('S3DISSegDataset', dict(num_points=256,
                                            patch_sample=True)),
    's3dis-test': ('S3DISSegDataset', dict(num_points=256, test_mode=True)),
    'scannet': ('ScanNetSegDataset', dict(num_points=300)),
    'scannet-xyz': ('ScanNetSegDataset', dict(num_points=300,
                                              use_color=False)),
    'semantickitti': ('SemanticKITTIDataset', dict(num_points=400)),
}


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _compare(cls, root, info, kw):
    port = getattr(tsd, cls)(root, info, seed=3, **kw)
    ref = getattr(jsd, cls)(root, info, seed=3, **kw)
    assert len(port) == len(ref) and port.CLASSES == ref.CLASSES
    for i in [*range(len(port)), 1, 0]:
        _same(port[i], ref[i])
    for got, want in zip(port.epoch_batches(2, seed=5),
                         ref.epoch_batches(2, seed=5)):
        _same(got, want)
    return port


@pytest.mark.parametrize('case', sorted(CASES))
def test_dataset_matches_gga_tpu(case, tmp_path):
    cls, kw = CASES[case]
    info = _fixture(str(tmp_path), case.split('-')[0])
    port = _compare(cls, str(tmp_path), info, kw)
    s = port[0]
    assert s['points'].shape[0] == kw['num_points']
    labels = np.concatenate([port[i]['seg_labels'] for i in range(len(port))])
    if cls == 'ScanNetSegDataset':
        assert s['points'].shape[1] == (6 if kw.get('use_color', True)
                                        else 3)
        assert labels.max() == 20 and labels.min() == 0
    elif cls == 'SemanticKITTIDataset':
        assert set(np.unique(labels)) <= set(range(19)) | {255}
        assert 255 in labels


def test_s3dis_from_the_ports_stage1(tmp_path):
    root = str(tmp_path)
    write_s3dis(root, np.random.RandomState(0))
    pkls = create_data.main(['s3dis', '--root-path', root, '--out-dir', root,
                             '--workers', '1'])
    port = _compare('S3DISSegDataset', root, pkls['Area_1'],
                    dict(num_points=512))
    assert port[0]['points'].shape == (512, 6)
    np.testing.assert_array_equal(
        port.load_instance_mask(1),
        jsd.S3DISSegDataset(root, pkls['Area_1']).load_instance_mask(1))
    assert os.path.exists(os.path.join(root, 'seg_info',
                                       'Area_1_label_weight.npy'))


def _preds(seed, num_classes, n_scenes=3, n=400):
    rng = np.random.RandomState(seed)
    gt = [rng.randint(0, num_classes - 2, n) for _ in range(n_scenes)]
    for g in gt:
        g[:30] = 255                       # ignored
    # the last class in neither: its IoU and accuracy NaN
    pred = [np.where(rng.rand(n) < 0.7, g,
                     rng.randint(0, num_classes - 1, n)) for g in gt]
    return gt, pred


def _equal_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('seed', (0, 1))
def test_seg_eval_matches_gga_tpu(seed):
    label2cat = dict(enumerate(jsd.S3DIS_CLASSES))
    gt, pred = _preds(seed, len(label2cat))
    got = tse.seg_eval(gt, pred, label2cat, 255)
    want = jse.seg_eval(gt, pred, label2cat, 255)
    _equal_dicts(got, want)
    # the class absent from labels and predictions: NaN, left out
    assert any(np.isnan(v) for v in want.values())
    assert np.isfinite(want['miou'])
    h = tse.fast_hist(pred[0], gt[0], 13)
    np.testing.assert_array_equal(h, jse.fast_hist(pred[0], gt[0], 13))


@pytest.mark.parametrize('form', ('masks', 'id_map'))
def test_instance_seg_eval_matches_gga_tpu(form):
    rng = np.random.RandomState(4)
    n, names, ids = 1200, ('chair', 'table', 'sofa'), (5, 7, 9)
    sem, inst, pm, pl, ps = [], [], [], [], []
    for _ in range(2):
        ins = np.repeat(np.arange(6), n // 6)
        cls = rng.randint(0, 4, 6)              # 3: ignored
        sem.append(cls[ins])
        inst.append(ins)
        masks = [(ins == i) ^ (rng.rand(n) < 0.03) for i in range(6)]
        masks.append(rng.rand(n) < 0.05)        # below min_region_size
        if form == 'masks':
            pm.append(np.stack(masks))
        else:
            pm.append(np.where(rng.rand(n) < 0.9, ins, 6))
        pl.append(np.concatenate([np.minimum(cls, 2), [1]])[:len(masks)])
        ps.append(rng.rand(len(masks)))
    got = tse.instance_seg_eval(sem, inst, pm, pl, ps, ids, names)
    want = jse.instance_seg_eval(sem, inst, pm, pl, ps, ids, names)
    _equal_dicts(got, want)
    assert 0 < want['all_ap_50%'] <= 1
