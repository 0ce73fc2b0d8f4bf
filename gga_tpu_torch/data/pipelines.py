"""Host-side input pipeline: functional transforms over sample dicts and
static-shape batch formatting (the port's copy of
``gga_tpu/data/pipelines.py``; items stay numpy).

Rebuilds the reference GGA train pipeline
(configs/gga/gga_kitti_config.py:112-137):
LoadPointsFromFile -> LoadAnnotations3D(with_gga) -> ObjectSample_GGA ->
PointsRangeFilter -> ObjectRangeFilter_GGA -> PointShuffle -> format.

Instead of ragged DataContainers (DefaultFormatBundle3D_GGA,
mmdet3d/datasets/pipelines/gga_processing.py:385-493), every sample
becomes fixed-shape padded arrays — points to [P, 4], objects to [M],
in-box clusters to [M, Pc, 2] with masks — so batches stack into the
static shapes of ``apis.train_step``.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import np_geometry as ng


def load_sample(info, root, pts_prefix='velodyne_reduced',
                classes=('Pedestrian', 'Cyclist', 'Car')):
    """Scene info -> sample dict (points + annotations, DontCare dropped).

    Mirrors KittiDataset_GGA_train.get_ann_info
    (mmdet3d/datasets/kitti_dataset_GGA_train.py:146) +
    LoadAnnotations3D(with_gga) (loading.py:650)."""
    calib = info['calib']
    rect = calib['R0_rect'].astype(np.float32)
    Trv2c = calib['Tr_velo_to_cam'].astype(np.float32)
    P2 = calib['P2'].astype(np.float32)
    lidar2img = P2 @ rect @ Trv2c

    vpath = info['point_cloud']['velodyne_path']
    red = vpath.replace('velodyne', pts_prefix)
    path = os.path.join(root, red)
    if not os.path.exists(path):
        path = os.path.join(root, vpath)
    points = np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    annos = info['annos']
    keep = annos['name'] != 'DontCare'
    name = annos['name'][keep]
    loc = annos['location'][keep]
    dims = annos['dimensions'][keep]
    rots = annos['rotation_y'][keep]
    gt_cam = np.concatenate([loc, dims, rots[..., None]],
                            axis=1).astype(np.float32)
    gt_lidar = ng.box_camera_to_lidar(gt_cam, rect, Trv2c)

    labels = np.array([classes.index(n) if n in classes else -1
                       for n in name], np.int64)
    n = keep.sum()
    sample = dict(
        sample_idx=info['image']['image_idx'],
        points=points,
        gt_bboxes_3d=gt_lidar.astype(np.float32),
        gt_labels_3d=labels,
        gt_names=name,
        rect=rect, Trv2c=Trv2c, P2=P2, lidar2img=lidar2img,
        image_shape=info['image']['image_shape'],
        GGA_boxes_img=annos['GGA_boxes_img'][keep].astype(np.float32),
        GGA_bdry_masks=annos['GGA_bdry_masks'][keep],
        GGA_mask_valid=(annos['GGA_mask_valid']
                        & annos['GGA_mask2d']
                        & annos['GGA_mask_depth'])[keep],
        GGA_init_pseudo_labels=annos['GGA_init_pseudo_label'][keep]
        .astype(np.float32),
        GGA_difficulty=annos['difficulty'][keep],
        GGA_num_points_in_box2d=annos['GGA_num_points_in_box2d'][keep],
        GGA_in_box_points=[np.asarray(annos['GGA_in_box_points'][i])
                           .reshape(-1, 3)[:, :3]
                           for i in np.where(keep)[0]],
        GGA_lidar2img=np.tile(lidar2img[None], (int(n), 1, 1)),
    )
    return sample


def object_sample_gga(sample, db_sampler, min_distance=5.0, rng=None):
    """Copy-paste augmentation (ObjectSample_GGA, gga_processing.py:22):
    sample db objects, remove scene points within min_distance (BEV) of
    their pseudo centers, concat their frustum crops + GGA fields."""
    ret = db_sampler.sample_all(
        sample['GGA_init_pseudo_labels'], sample['gt_labels_3d'],
        sample['GGA_mask_valid'], min_distance)
    if ret is None:
        return sample
    pts = sample['points']
    d = np.linalg.norm(
        pts[:, None, :2] - ret['GGA_init_pseudo_labels'][None, :, :2],
        axis=-1)
    pts = pts[~(d < min_distance).any(-1)]
    sample['points'] = np.concatenate([ret['points'], pts])
    sample['gt_bboxes_3d'] = np.concatenate(
        [sample['gt_bboxes_3d'], ret['gt_bbox_3ds'].astype(np.float32)])
    sample['gt_labels_3d'] = np.concatenate(
        [sample['gt_labels_3d'], ret['gt_labels_3d']])
    sample['GGA_boxes_img'] = np.concatenate(
        [sample['GGA_boxes_img'], ret['GGA_box_imgs'].astype(np.float32)])
    sample['GGA_lidar2img'] = np.concatenate(
        [sample['GGA_lidar2img'],
         ret['GGA_lidar2imgs'].astype(np.float32)])
    sample['GGA_init_pseudo_labels'] = np.concatenate(
        [sample['GGA_init_pseudo_labels'],
         ret['GGA_init_pseudo_labels'].astype(np.float32)])
    sample['GGA_mask_valid'] = np.concatenate(
        [sample['GGA_mask_valid'], ret['GGA_mask_valids']])
    sample['GGA_bdry_masks'] = np.concatenate(
        [sample['GGA_bdry_masks'], ret['GGA_bdry_masks']])
    sample['GGA_difficulty'] = np.concatenate(
        [sample['GGA_difficulty'], ret['GGA_difficulties']])
    sample['GGA_num_points_in_box2d'] = np.concatenate(
        [sample['GGA_num_points_in_box2d'],
         ret['GGA_num_points_in_box2ds']])
    sample['GGA_in_box_points'] = (list(sample['GGA_in_box_points'])
                                   + list(ret['GGA_in_box_points']))
    return sample


def points_range_filter(sample, pc_range):
    """PointsRangeFilter (transforms_3d.py:942)."""
    pts = sample['points']
    r = np.asarray(pc_range)
    m = ((pts[:, 0] > r[0]) & (pts[:, 1] > r[1]) & (pts[:, 2] > r[2])
         & (pts[:, 0] < r[3]) & (pts[:, 1] < r[4]) & (pts[:, 2] < r[5]))
    sample['points'] = pts[m]
    return sample


def object_range_filter_gga(sample, pc_range, num_points_range=15):
    """ObjectRangeFilter_GGA (gga_processing.py:214): keep objects with
    valid mask, > num_points_range frustum points, difficulty > -1, and
    pseudo center in BEV range. Limits GT yaw to [-pi, pi]."""
    r = np.asarray(pc_range)[[0, 1, 3, 4]]
    ip = sample['GGA_init_pseudo_labels']
    in_range = ((ip[:, 0] > r[0]) & (ip[:, 1] > r[1])
                & (ip[:, 0] < r[2]) & (ip[:, 1] < r[3]))
    mask = (sample['GGA_mask_valid']
            & (sample['GGA_num_points_in_box2d'] > num_points_range)
            & (sample['GGA_difficulty'] > -1)
            & in_range)
    for k in ('gt_labels_3d', 'gt_bboxes_3d', 'GGA_boxes_img',
              'GGA_bdry_masks', 'GGA_lidar2img', 'GGA_init_pseudo_labels',
              'GGA_mask_valid', 'GGA_difficulty',
              'GGA_num_points_in_box2d'):
        sample[k] = sample[k][mask]
    sample['GGA_in_box_points'] = [
        c for c, m in zip(sample['GGA_in_box_points'], mask) if m]
    sample['gt_bboxes_3d'][:, 6] = ng.limit_period(
        sample['gt_bboxes_3d'][:, 6], 0.5, 2 * np.pi)
    return sample


def point_shuffle(sample, rng):
    sample['points'] = sample['points'][
        rng.permutation(sample['points'].shape[0])]
    return sample


def format_gga_batch_item(sample, max_points, max_objs, max_cluster_pts,
                          rng=None):
    """Sample dict -> fixed-shape arrays for the train step.

    Clusters larger than max_cluster_pts are uniformly subsampled (delta
    vs the reference, which sums PAL over all cluster points — documented
    in SURVEY/centerpoint_head_gga docstrings).
    """
    rng = rng or np.random.RandomState(0)
    P, M, Pc = max_points, max_objs, max_cluster_pts
    pts = sample['points'][:P]
    n_pts = pts.shape[0]
    points = np.zeros((P, 4), np.float32)
    points[:n_pts] = pts[:, :4]
    points_valid = np.zeros((P,), bool)
    points_valid[:n_pts] = True

    n = min(len(sample['gt_labels_3d']), M)
    labels = np.full((M,), -1, np.int32)
    labels[:n] = sample['gt_labels_3d'][:n]
    obj_valid = np.zeros((M,), bool)
    obj_valid[:n] = True
    init_pseudo = np.zeros((M, 7), np.float32)
    init_pseudo[:n] = sample['GGA_init_pseudo_labels'][:n]
    boxes_img = np.zeros((M, 4), np.float32)
    boxes_img[:n] = sample['GGA_boxes_img'][:n]
    bdry = np.zeros((M, 4), bool)
    bdry[:n] = sample['GGA_bdry_masks'][:n]
    l2i = np.broadcast_to(np.eye(4, dtype=np.float32), (M, 4, 4)).copy()
    l2i[:n] = sample['GGA_lidar2img'][:n]
    gt_boxes = np.zeros((M, 7), np.float32)
    gt_boxes[:n] = sample['gt_bboxes_3d'][:n]

    ibp = np.zeros((M, Pc, 2), np.float32)
    ibp_valid = np.zeros((M, Pc), bool)
    for i in range(n):
        c = np.asarray(sample['GGA_in_box_points'][i]).reshape(-1, 3)
        if c.shape[0] > Pc:
            c = c[rng.choice(c.shape[0], Pc, replace=False)]
        ibp[i, :c.shape[0]] = c[:, :2]
        ibp_valid[i, :c.shape[0]] = True

    return dict(points=points, points_valid=points_valid, labels=labels,
                obj_valid=obj_valid, init_pseudo=init_pseudo,
                boxes_img=boxes_img, bdry_masks=bdry, lidar2img=l2i,
                ibp_xy=ibp, ibp_valid=ibp_valid, gt_boxes=gt_boxes)


def collate(items):
    """Stack a list of formatted items into a batch dict."""
    return {k: np.stack([it[k] for it in items]) for k in items[0]}
