"""The port's indoor converters and their command line against gga_tpu's,
CPU. Raw SUN RGB-D, ScanNet and S3DIS layouts as
``tests/test_data/test_indoor_converter.py`` writes them (a few scenes
each, with unknown classes, a scene with no object, ScanNet posed
images with a non-finite pose, a test split and two S3DIS areas) are
copied to two roots; gga_tpu's ``create_*_infos`` converts one, the
port's ``tools/create_data.main`` the other, on a pool of threads. The
infos must be equal (the same keys, arrays of the same dtype and
values), every file written (``.bin`` dumps, ``seg_info`` ``.npy``) the
same bytes.

Also: ``jpeg_shape`` equals Pillow's (height, width) on baseline and
progressive JPEGs (colour and grey, with and without an EXIF block) and
refuses what has no frame header; the subcommands that are not ported
raise NotImplementedError naming their ROADMAP item.
"""
import os
import pickle
import shutil

import numpy as np
import pytest
from PIL import Image

from gga_tpu.data import indoor_converter as jic
from gga_tpu_torch.data import indoor_converter as tic
from gga_tpu_torch.tools import create_data


def write_sunrgbd(root, rng):
    from scipy import io as sio
    tv = os.path.join(root, 'sunrgbd_trainval')
    for d in ('depth', 'label', 'calib', 'image'):
        os.makedirs(os.path.join(tv, d))
    objs = [('bed', (1.0, 2.0, 0.4), (2.0, 1.5, 0.8), 0.3),
            ('table', (-1.0, 1.5, 0.3), (0.9, 0.9, 0.6), -0.2),
            ('unknown_cls', (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 0.0),
            ('night_stand', (0.5, -1.0, 0.2), (0.5, 0.4, 0.6), 2.9)]
    for n, idx in enumerate((0, 5, 7)):
        pts = rng.uniform(-3, 3, (1500 + 100 * n, 6))
        sio.savemat(os.path.join(tv, 'depth', f'{idx:06d}.mat'),
                    {'instance': pts})
        with open(os.path.join(tv, 'label', f'{idx:06d}.txt'), 'w') as f:
            # scene 7 holds only an unknown class
            for name, c, s, yaw in (objs[2:3] if idx == 7 else objs):
                f.write(f'{name} 10 20 30 40 {c[0]} {c[1]} {c[2]} '
                        f'{s[1] / 2} {s[0] / 2} {s[2] / 2} {np.cos(yaw)} '
                        f'{np.sin(yaw)}\n')
        with open(os.path.join(tv, 'calib', f'{idx:06d}.txt'), 'w') as f:
            rt = rng.randn(9)
            k = np.diag([500. + idx, 510., 1.]).reshape(-1, order='F')
            f.write(' '.join(str(x) for x in rt) + '\n')
            f.write(' '.join(str(x) for x in k) + '\n')
        Image.new('RGB', (64 + idx, 48 + 2 * idx)).save(
            os.path.join(tv, 'image', f'{idx:06d}.jpg'),
            progressive=bool(n % 2))
    with open(os.path.join(tv, 'train_data_idx.txt'), 'w') as f:
        f.write('0\n5\n7\n')
    with open(os.path.join(tv, 'val_data_idx.txt'), 'w') as f:
        f.write('5\n')


def write_scannet(root, rng):
    inst = os.path.join(root, 'scannet_instance_data')
    os.makedirs(inst)
    os.makedirs(os.path.join(root, 'meta_data'))
    scenes = dict(train=['scene0000_00', 'scene0001_00'],
                  val=['scene0002_00'], test=['scene0707_00'])
    for n, scene in enumerate(sum(scenes.values(), [])):
        pts = rng.uniform(-2, 2, (700 + 50 * n, 6)).astype(np.float32)
        np.save(os.path.join(inst, f'{scene}_vert.npy'), pts)
        aligned = (np.array([[0, 0, 0, 1, 1, 1, 4],
                             [1, 1, 0.5, 0.5, 0.5, 0.5, 7],
                             [-1, 0.5, 0.2, 0.4, 0.6, 0.8, 39]])[:3 - n]
                   if n < 3 else np.zeros((0, 7)))
        np.save(os.path.join(inst, f'{scene}_aligned_bbox.npy'), aligned)
        np.save(os.path.join(inst, f'{scene}_unaligned_bbox.npy'),
                aligned + 0.1)
        np.save(os.path.join(inst, f'{scene}_axis_align_matrix.npy'),
                np.eye(4) + rng.randn(4, 4) * 0.01)
        np.save(os.path.join(inst, f'{scene}_sem_label.npy'),
                rng.choice([0, 1, 4, 7, 39, 40], len(pts)).astype(np.int64))
        np.save(os.path.join(inst, f'{scene}_ins_label.npy'),
                rng.randint(0, 3, len(pts)).astype(np.int64))
    posed = os.path.join(root, 'posed_images', 'scene0000_00')
    os.makedirs(posed)
    np.savetxt(os.path.join(posed, 'intrinsic.txt'), np.eye(4) * 500)
    for i in range(3):
        Image.new('RGB', (8, 8)).save(os.path.join(posed, f'{i:05d}.jpg'))
        pose = np.eye(4) + i
        if i == 1:
            pose[0, 0] = np.inf          # a frame without a pose
        np.savetxt(os.path.join(posed, f'{i:05d}.txt'), pose)
    for split, names in scenes.items():
        with open(os.path.join(root, 'meta_data',
                               f'scannetv2_{split}.txt'), 'w') as f:
            f.write('\n'.join(names) + '\n')


def write_s3dis(root, rng):
    data = os.path.join(root, 's3dis_data')
    os.makedirs(data)
    for stem in ('Area_1_office_1', 'Area_1_office_2', 'Area_2_hallway_1'):
        n = 600
        pts = rng.uniform(0, 4, (n, 6)).astype(np.float32)
        sem = np.full(n, 2, np.int64)
        ins = np.zeros(n, np.int64)
        for i, label in enumerate((8, 7, 3), 1):   # chair, table, a wall
            sel = np.arange(50 * i, 50 * i + 40)
            pts[sel, :3] = rng.uniform(0, 1, (40, 3)) + i
            sem[sel] = label
            ins[sel] = i
        np.save(os.path.join(data, f'{stem}_point.npy'), pts)
        np.save(os.path.join(data, f'{stem}_sem_label.npy'), sem)
        np.save(os.path.join(data, f'{stem}_ins_label.npy'), ins)


WRITERS = dict(sunrgbd=write_sunrgbd, scannet=write_scannet,
               s3dis=write_s3dis)
REFERENCE = dict(sunrgbd=jic.create_sunrgbd_infos,
                 scannet=jic.create_scannet_infos,
                 s3dis=jic.create_s3dis_infos)


def _equal(a, b, where):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _equal(a[k], b[k], f'{where}.{k}')
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f'{where}[{i}]')
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope='module', params=sorted(WRITERS))
def converted(request, tmp_path_factory):
    name = request.param
    base = tmp_path_factory.mktemp(name)
    raw = str(base / 'raw')
    WRITERS[name](raw, np.random.RandomState(0))
    port, ref = str(base / 'port'), str(base / 'ref')
    shutil.copytree(raw, port)
    shutil.copytree(raw, ref)
    kw = dict(areas=(1, 2)) if name == 's3dis' else {}
    ref_paths = REFERENCE[name](ref, workers=1, **kw)
    paths = create_data.main([name, '--root-path', port, '--out-dir', port,
                              '--workers', '3'])
    return name, port, ref, paths, ref_paths


def test_infos_equal_gga_tpu(converted):
    name, port, ref, paths, ref_paths = converted
    assert sorted(paths) == sorted(ref_paths) and paths
    for split in ref_paths:
        assert os.path.relpath(paths[split], port) == os.path.relpath(
            ref_paths[split], ref)
        with open(paths[split], 'rb') as f:
            got = pickle.load(f)
        with open(ref_paths[split], 'rb') as f:
            want = pickle.load(f)
        assert len(want) > 0
        _equal(got, want, f'{name}.{split}')


def test_written_files_equal_gga_tpu(converted):
    name, port, ref = converted[:3]
    files = _files(ref)
    assert _files(port) == files
    dumps = [f for f in files if f.endswith(('.bin', '.npy'))
             and not f.startswith(('scannet_instance_data', 's3dis_data'))]
    assert dumps
    for f in dumps:
        with open(os.path.join(port, f), 'rb') as a, \
                open(os.path.join(ref, f), 'rb') as b:
            assert a.read() == b.read(), f


def test_converted_annos_hold_what_was_written(converted):
    """The boxes and classes written into the raw layout come back."""
    name, port, _, paths, _ = converted
    with open(paths['train' if name != 's3dis' else 'Area_1'], 'rb') as f:
        infos = pickle.load(f)
    a = infos[0]['annos']
    if name == 'sunrgbd':
        assert [i['annos']['gt_num'] for i in infos] == [3, 3, 0]
        np.testing.assert_array_equal(a['class'], [0, 1, 7])
        np.testing.assert_allclose(a['gt_boxes_upright_depth'][0],
                                   [1.0, 2.0, 0.4, 2.0, 1.5, 0.8, 0.3],
                                   atol=1e-6)
        assert tuple(infos[0]['image']['image_shape']) == (48, 64)
    elif name == 'scannet':
        np.testing.assert_array_equal(a['class'], [1, 4, 17])
        assert len(infos[0]['img_paths']) == 2
    else:
        np.testing.assert_array_equal(a['class'], [1, 0])
    for info in infos:
        pts = np.fromfile(os.path.join(port, info['pts_path']), np.float32)
        assert pts.size % 6 == 0 and pts.size > 0


@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('mode,size,exif', [('RGB', (640, 480), False),
                                            ('L', (33, 1001), False),
                                            ('RGB', (1, 1), True)])
def test_jpeg_shape_equals_pillow(tmp_path, progressive, mode, size, exif):
    path = str(tmp_path / 'a.jpg')
    im = Image.new(mode, size)
    kw = {}
    if exif:
        block = Image.Exif()
        block[0x010F] = 'x' * 300              # an APP1 segment first
        kw['exif'] = block
    im.save(path, progressive=progressive, quality=90, **kw)
    with open(path, 'rb') as f:
        sof = b'\xff\xc2' if progressive else b'\xff\xc0'
        assert sof in f.read()
    with Image.open(path) as ref:
        assert tic.jpeg_shape(path) == (ref.height, ref.width)


def test_jpeg_shape_refuses_what_has_no_frame_header(tmp_path):
    good = tmp_path / 'a.jpg'
    Image.new('RGB', (20, 10)).save(str(good))
    data = good.read_bytes()
    cut = data.index(b'\xff\xc0')
    for name, body in (('png', b'\x89PNG\r\n\x1a\n' + data[2:]),
                       ('cut', data[:cut]),
                       ('scan_first', data[:cut] + b'\xff\xda\x00\x02'),
                       ('no_height', data[:cut + 5] + b'\x00\x00'
                        + data[cut + 7:])):
        p = tmp_path / f'{name}.jpg'
        p.write_bytes(body)
        with pytest.raises(ValueError):
            tic.jpeg_shape(str(p))


@pytest.mark.parametrize('dataset,item', [('nuscenes', 'item 9'),
                                          ('lyft', 'item 9'),
                                          ('waymo', 'item 10'),
                                          ('nuimages', 'item 10')])
def test_unported_datasets_name_their_roadmap_item(tmp_path, dataset, item):
    with pytest.raises(NotImplementedError, match=item):
        create_data.main([dataset, '--root-path', str(tmp_path),
                          '--out-dir', str(tmp_path)])
