"""Indoor raw-data converters: SUN RGB-D, ScanNet, S3DIS (the port's copy
of ``gga_tpu/data/indoor_converter.py``; mmdet3d's indoor_converter with
its sunrgbd / scannet / s3dis data utils).

Each converter reads the community-preprocessed raw layout:

- SUN RGB-D: ``sunrgbd_trainval/{depth/*.mat, label/*.txt, calib/*.txt,
  image/*.jpg, train_data_idx.txt, val_data_idx.txt}``
- ScanNet: ``meta_data/scannetv2_{split}.txt`` +
  ``scannet_instance_data/{id}_{vert,aligned_bbox,unaligned_bbox,
  axis_align_matrix,sem_label,ins_label}.npy`` (+ optional posed_images)
- S3DIS: ``s3dis_data/Area-room_{point,sem_label,ins_label}.npy``

and writes the mmdet3d info-pkl protocol the port's datasets read
(``data/sunrgbd.py``, ``data/scannet.py``): flat ``points/`` (+
``semantic_mask/``, ``instance_mask/``) .bin dumps and per-split
``<prefix>_infos_<split>.pkl`` files, plus ``seg_info/`` resampled scene
indices and PointNet++ label weights for the segmentation task. Host
code only: numpy, and scipy for the SUN RGB-D depth ``.mat`` files. An
image's shape comes from its JPEG frame header (``jpeg_shape``), not
from an image library.
"""
from __future__ import annotations

import os
import pickle
import struct
from concurrent import futures

import numpy as np

# ---------------------------------------------------------------------------
# shared helpers


def _dump_pkl(obj, path):
    with open(path, 'wb') as f:
        pickle.dump(obj, f)
    print(f'saved {path}')


def _tofile(arr, root, subdir, name):
    os.makedirs(os.path.join(root, subdir), exist_ok=True)
    arr.tofile(os.path.join(root, subdir, name))
    return os.path.join(subdir, name)


def _map_scenes(fn, ids, workers):
    """``fn`` over ``ids`` in their order, on a thread pool above one
    worker."""
    if workers and workers > 1:
        with futures.ThreadPoolExecutor(workers) as ex:
            return list(ex.map(fn, ids))
    return [fn(i) for i in ids]


def compute_seg_info(infos, root, *, num_classes, cat_id2class,
                     num_points, out_dir, split,
                     label_weight_func=None):
    """Resampled scene indices + label weights for segmentation training
    (ScanNetSegData / S3DISSegData.get_scene_idxs_and_label_weight):
    scenes are repeated in proportion to their point count so each epoch
    covers the corpus, and a class's weight is ``1 / log(1.2 + freq)``
    (PointNet++)."""
    if label_weight_func is None:
        label_weight_func = lambda x: 1.0 / np.log(1.2 + x)  # noqa: E731
    counts = np.zeros(num_classes + 1)
    n_pts = []
    for info in infos:
        mask = np.fromfile(os.path.join(root, info['pts_semantic_mask_path']),
                           np.int64)
        label = cat_id2class[mask]
        n_pts.append(label.shape[0])
        counts += np.histogram(label, range(num_classes + 2))[0]
    n_pts = np.asarray(n_pts, np.float64)
    num_iter = int(n_pts.sum() / num_points)
    prob = n_pts / n_pts.sum()
    scene_idxs = np.concatenate([
        np.full(int(round(prob[i] * num_iter)), i, np.int32)
        for i in range(len(infos))]) if len(infos) else np.zeros(0, np.int32)
    w = counts[:-1].astype(np.float32)
    w = label_weight_func(w / w.sum()).astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f'{split}_resampled_scene_idxs.npy'),
            scene_idxs)
    np.save(os.path.join(out_dir, f'{split}_label_weight.npy'), w)
    return scene_idxs, w


# the JPEG start-of-frame markers (SOF0-SOF15 less DHT, JPG and DAC): each
# carries the frame's height and width
_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
# markers with no length field after them: TEM, RST0-7, SOI, EOI
_BARE = frozenset((0x01, *range(0xD0, 0xDA)))


def jpeg_shape(path):
    """(height, width) of a JPEG file, read from its start-of-frame
    marker (baseline SOF0, progressive SOF2, or any other SOFn).

    Walks the marker segments from SOI to the first SOFn. Raises
    ValueError where the file is no JPEG, ends early, reaches the scan
    (SOS) without a frame header, or gives a height of 0 (a height
    defined by a later DNL marker); it never guesses a shape."""
    with open(path, 'rb') as f:
        data = f.read()
    if data[:2] != b'\xff\xd8':
        raise ValueError(f'{path}: not a JPEG file (no SOI marker)')
    pos = 2
    while True:
        # a marker is 0xFF, any number of 0xFF fill bytes, then its code
        if pos >= len(data) or data[pos] != 0xFF:
            raise ValueError(f'{path}: no marker at byte {pos}')
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        if pos >= len(data):
            raise ValueError(f'{path}: ends inside a marker')
        code = data[pos]
        pos += 1
        if code in _BARE:
            continue
        if code == 0xDA:
            raise ValueError(f'{path}: the scan starts before any '
                             'start-of-frame marker')
        if pos + 2 > len(data):
            raise ValueError(f'{path}: ends inside marker 0xFF{code:02X}')
        (length,) = struct.unpack('>H', data[pos:pos + 2])
        if code in _SOF:
            if length < 8 or pos + 7 > len(data):
                raise ValueError(f'{path}: short frame header')
            height, width = struct.unpack('>HH', data[pos + 3:pos + 7])
            if height == 0 or width == 0:
                raise ValueError(f'{path}: frame header gives {height} x '
                                 f'{width}')
            return height, width
        pos += length


# ---------------------------------------------------------------------------
# SUN RGB-D

SUNRGBD_CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                   'dresser', 'night_stand', 'bookshelf', 'bathtub')


def _parse_sunrgbd_label_line(line):
    """One ``label/xxxxxx.txt`` line -> dict (sunrgbd_data_utils.py:31).

    Format: name xmin ymin dx dy cx cy cz w l h ox oy; sizes are
    half-extents (doubled here), heading = atan2(oy, ox), box3d is
    (cx cy cz l w h yaw) with l along x.
    """
    parts = line.split(' ')
    vals = np.array([float(x) for x in parts[1:]])
    box2d = np.array([vals[0], vals[1], vals[0] + vals[2],
                      vals[1] + vals[3]])
    centroid = vals[4:7]
    w, length, h = vals[7], vals[8], vals[9]
    heading = np.arctan2(vals[11], vals[10])
    return dict(name=parts[0], box2d=box2d, centroid=centroid,
                size=np.array([length, w, h]) * 2, heading=heading)


def _read_sunrgbd_calib(path):
    with open(path) as f:
        lines = [ln.rstrip() for ln in f]
    rt = np.array([float(x) for x in lines[0].split(' ')],
                  np.float32).reshape(3, 3, order='F')
    k = np.array([float(x) for x in lines[1].split(' ')],
                 np.float32).reshape(3, 3, order='F')
    return k, rt


def _image_shape(path):
    return np.array(jpeg_shape(path), np.int32)


def create_sunrgbd_infos(root, out_dir=None, *, splits=('train', 'val'),
                         workers=4, num_points=-1, use_v1=False, seed=0):
    """SUN RGB-D trainval -> points/*.bin + sunrgbd_infos_{split}.pkl.
    Returns {split: pkl path}."""
    from scipy import io as sio

    out_dir = out_dir or root
    os.makedirs(out_dir, exist_ok=True)
    tv = os.path.join(root, 'sunrgbd_trainval')
    label_dir = os.path.join(tv, 'label_v1' if use_v1 else 'label')
    cat2label = {c: i for i, c in enumerate(SUNRGBD_CLASSES)}
    rng = np.random.RandomState(seed)

    def one(idx):
        pts = sio.loadmat(
            os.path.join(tv, 'depth', f'{idx:06d}.mat'))['instance']
        pts = np.ascontiguousarray(pts, np.float32)
        if num_points > 0:
            sel = rng.choice(pts.shape[0], num_points,
                             replace=pts.shape[0] < num_points)
            pts = pts[sel]
        pts_path = _tofile(pts, root, 'points', f'{idx:06d}.bin')

        k, rt = _read_sunrgbd_calib(os.path.join(tv, 'calib',
                                                 f'{idx:06d}.txt'))
        img_path = os.path.join('image', f'{idx:06d}.jpg')
        info = dict(
            point_cloud=dict(num_features=6, lidar_idx=idx),
            pts_path=pts_path,
            image=dict(image_idx=idx,
                       image_shape=_image_shape(os.path.join(tv, img_path)),
                       image_path=img_path),
            calib=dict(K=k, Rt=rt))

        with open(os.path.join(label_dir, f'{idx:06d}.txt')) as f:
            objs = [_parse_sunrgbd_label_line(ln.rstrip())
                    for ln in f if ln.strip()]
        objs = [o for o in objs if o['name'] in cat2label]
        annos = dict(gt_num=len(objs))
        if objs:
            annos.update(
                name=np.array([o['name'] for o in objs]),
                bbox=np.stack([o['box2d'] for o in objs]),
                location=np.stack([o['centroid'] for o in objs]),
                dimensions=np.stack([o['size'] for o in objs]),
                rotation_y=np.array([o['heading'] for o in objs]),
                index=np.arange(len(objs), dtype=np.int32),
                **{'class': np.array([cat2label[o['name']]
                                      for o in objs])},
                gt_boxes_upright_depth=np.stack([
                    np.concatenate([o['centroid'], o['size'],
                                    [o['heading']]]) for o in objs]))
        info['annos'] = annos
        return info

    out_paths = {}
    for split in splits:
        with open(os.path.join(tv, f'{split}_data_idx.txt')) as f:
            ids = [int(x) for x in f.read().split()]
        infos = _map_scenes(one, ids, workers)
        path = os.path.join(out_dir, f'sunrgbd_infos_{split}.pkl')
        _dump_pkl(infos, path)
        out_paths[split] = path
    return out_paths


# ---------------------------------------------------------------------------
# ScanNet

SCANNET_CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
                   'window', 'bookshelf', 'picture', 'counter', 'desk',
                   'curtain', 'refrigerator', 'showercurtrain', 'toilet',
                   'sink', 'bathtub', 'garbagebin')
SCANNET_DET_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
SCANNET_SEG_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


def _scannet_seg_lut():
    lut = np.full(41, len(SCANNET_SEG_IDS), np.int64)
    lut[SCANNET_SEG_IDS] = np.arange(len(SCANNET_SEG_IDS))
    return lut


def create_scannet_infos(root, out_dir=None, *,
                         splits=('train', 'val', 'test'), workers=4,
                         seg_num_points=8192):
    """ScanNet instance data -> bins + scannet_infos_{split}.pkl + the
    seg_info resampling and label weights (train / val). Splits without
    a ``meta_data`` file are skipped. Returns {split: pkl path}."""
    out_dir = out_dir or root
    os.makedirs(out_dir, exist_ok=True)
    inst_dir = os.path.join(root, 'scannet_instance_data')
    id2class = {int(c): i for i, c in enumerate(SCANNET_DET_IDS)}

    def one_factory(test_mode):
        def one(scene):
            pts = np.load(os.path.join(inst_dir, f'{scene}_vert.npy'))
            pts_path = _tofile(pts.astype(np.float32), root, 'points',
                               f'{scene}.bin')
            info = dict(point_cloud=dict(num_features=6, lidar_idx=scene),
                        pts_path=pts_path)

            posed = os.path.join(root, 'posed_images', scene)
            if os.path.isdir(posed):
                info['intrinsics'] = np.loadtxt(
                    os.path.join(posed, 'intrinsic.txt'))
                exts, imgs = [], []
                for f in sorted(os.listdir(posed)):
                    if f.endswith('.jpg'):
                        e = np.loadtxt(os.path.join(
                            posed, f.replace('.jpg', '.txt')))
                        if np.all(np.isfinite(e)):
                            exts.append(e)
                            imgs.append(os.path.join('posed_images',
                                                     scene, f))
                info['extrinsics'] = exts
                info['img_paths'] = imgs

            if not test_mode:
                for kind, key in (('instance', 'pts_instance_mask_path'),
                                  ('semantic', 'pts_semantic_mask_path')):
                    short = {'instance': 'ins', 'semantic': 'sem'}[kind]
                    mask = np.load(os.path.join(
                        inst_dir, f'{scene}_{short}_label.npy'))
                    info[key] = _tofile(mask.astype(np.int64), root,
                                        f'{kind}_mask', f'{scene}.bin')

                aligned = np.load(os.path.join(inst_dir,
                                               f'{scene}_aligned_bbox.npy'))
                unaligned = np.load(os.path.join(
                    inst_dir, f'{scene}_unaligned_bbox.npy'))
                annos = dict(gt_num=aligned.shape[0])
                if aligned.shape[0]:
                    cls = aligned[:, -1].astype(int)
                    annos.update(
                        name=np.array([SCANNET_CLASSES[id2class[c]]
                                       for c in cls]),
                        location=aligned[:, :3],
                        dimensions=aligned[:, 3:6],
                        gt_boxes_upright_depth=aligned[:, :6],
                        unaligned_location=unaligned[:, :3],
                        unaligned_dimensions=unaligned[:, 3:6],
                        unaligned_gt_boxes_upright_depth=unaligned[:, :6],
                        index=np.arange(aligned.shape[0], dtype=np.int32),
                        **{'class': np.array([id2class[c] for c in cls])})
                annos['axis_align_matrix'] = np.load(os.path.join(
                    inst_dir, f'{scene}_axis_align_matrix.npy'))
                info['annos'] = annos
            return info
        return one

    out_paths = {}
    for split in splits:
        split_file = os.path.join(root, 'meta_data',
                                  f'scannetv2_{split}.txt')
        if not os.path.exists(split_file):
            continue
        with open(split_file) as f:
            scenes = [ln.strip() for ln in f if ln.strip()]
        infos = _map_scenes(one_factory(split == 'test'), scenes, workers)
        path = os.path.join(out_dir, f'scannet_infos_{split}.pkl')
        _dump_pkl(infos, path)
        out_paths[split] = path
        if split != 'test':
            compute_seg_info(
                infos, root, num_classes=len(SCANNET_SEG_IDS),
                cat_id2class=_scannet_seg_lut(),
                num_points=seg_num_points,
                out_dir=os.path.join(root, 'seg_info'), split=split)
    return out_paths


# ---------------------------------------------------------------------------
# S3DIS

S3DIS_DET_IDS = np.array([7, 8, 9, 10, 11])  # table chair sofa bookcase board


def create_s3dis_infos(root, out_dir=None, *, areas=(1, 2, 3, 4, 5, 6),
                       workers=4, seg_num_points=4096):
    """S3DIS per-room npys -> bins + s3dis_infos_Area_N.pkl + seg_info.
    Areas with no room are skipped. Returns {'Area_N': pkl path}."""
    out_dir = out_dir or root
    os.makedirs(out_dir, exist_ok=True)
    data_dir = os.path.join(root, 's3dis_data')
    id2class = {int(c): i for i, c in enumerate(S3DIS_DET_IDS)}

    def boxes_from_instances(pts, ins, sem):
        """Axis-aligned boxes of the 5 furniture classes from instance
        masks (s3dis_data_utils.py:117)."""
        bboxes, labels = [], []
        for i in range(1, int(ins.max(initial=0)) + 1):
            m = ins == i
            if not m.any():
                continue
            label = int(sem[m][0])
            if not (sem[m] == label).all():
                raise ValueError(f'instance {i} has points of more than '
                                 'one semantic class')
            if label in id2class:
                lo, hi = pts[m, :3].min(0), pts[m, :3].max(0)
                bboxes.append(np.concatenate([(lo + hi) / 2, hi - lo]))
                labels.append(id2class[label])
        return dict(gt_boxes_upright_depth=np.array(bboxes),
                    **{'class': np.array(labels)}, gt_num=len(labels))

    def one(stem):
        pts = np.load(os.path.join(data_dir,
                                   f'{stem}_point.npy')).astype(np.float32)
        ins = np.load(os.path.join(data_dir,
                                   f'{stem}_ins_label.npy')).astype(np.int64)
        sem = np.load(os.path.join(data_dir,
                                   f'{stem}_sem_label.npy')).astype(np.int64)
        return dict(
            point_cloud=dict(num_features=6, lidar_idx=stem),
            pts_path=_tofile(pts, root, 'points', f'{stem}.bin'),
            pts_instance_mask_path=_tofile(ins, root, 'instance_mask',
                                           f'{stem}.bin'),
            pts_semantic_mask_path=_tofile(sem, root, 'semantic_mask',
                                           f'{stem}.bin'),
            annos=boxes_from_instances(pts, ins, sem))

    out_paths = {}
    for n in areas:
        split = f'Area_{n}'
        stems = sorted(f[:-len('_point.npy')]
                       for f in os.listdir(data_dir)
                       if f.startswith(split) and f.endswith('_point.npy'))
        if not stems:
            continue
        infos = _map_scenes(one, stems, workers)
        path = os.path.join(out_dir, f's3dis_infos_{split}.pkl')
        _dump_pkl(infos, path)
        out_paths[split] = path
        compute_seg_info(
            infos, root, num_classes=13,
            cat_id2class=np.arange(14, dtype=np.int64),
            num_points=seg_num_points,
            out_dir=os.path.join(root, 'seg_info'), split=split)
    return out_paths
