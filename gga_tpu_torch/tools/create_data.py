"""Dataset preparation (the port's copy of ``tools/create_data.py``, the
reference's tools/create_data.py surface): ``kitti`` hands off to the
port's ``create_data_gga``; ``sunrgbd``, ``scannet`` and ``s3dis``
convert the community-preprocessed raw layouts
(``data/indoor_converter.py``). Host code only.

``nuscenes``, ``lyft``, ``waymo`` and ``nuimages`` are not ported yet and
raise NotImplementedError naming the ROADMAP item that holds them.

Usage:
    python -m gga_tpu_torch.tools.create_data sunrgbd \\
        --root-path data/sunrgbd --out-dir data/sunrgbd
    python -m gga_tpu_torch.tools.create_data scannet \\
        --root-path data/scannet --out-dir data/scannet
"""
from __future__ import annotations

import argparse

from ..data import indoor_converter as ic

# the datasets the port cannot convert yet, with the ROADMAP item (§1)
# that holds each
_NOT_PORTED = dict(
    nuscenes="ROADMAP.md §1 item 9's list of what is left (the nuScenes "
             'info converter needs the nuScenes devkit)',
    lyft="ROADMAP.md §1 item 9's list of what is left (LyftDataset) and "
         'item 10 (the Lyft converter)',
    waymo='ROADMAP.md §1 item 10 (the Waymo converter and dataset)',
    nuimages='ROADMAP.md §1 item 10 (the nuScenes datasets and converters)')


def main(argv=None):
    """Parse ``argv`` and convert. Returns what the converter wrote: for
    the indoor datasets {split: info pkl path}, for kitti
    ``kitti_data_prep``'s summary."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('dataset', choices=['kitti', 'nuscenes', 'sunrgbd',
                                       'scannet', 's3dis', 'waymo',
                                       'lyft', 'nuimages'])
    p.add_argument('--root-path', required=True)
    p.add_argument('--out-dir', required=True)
    p.add_argument('--version', default='v1.0-trainval')
    p.add_argument('--max-sweeps', type=int, default=10)
    p.add_argument('--workers', type=int, default=16)
    p.add_argument('--num-points', type=int, default=-1,
                   help='sunrgbd: subsample each depth cloud (-1 = all)')
    p.add_argument('--use-v1', action='store_true',
                   help='sunrgbd: use the v1 label set')
    args = p.parse_args(argv)

    if args.dataset in _NOT_PORTED:
        raise NotImplementedError(
            f'create_data {args.dataset}: not ported yet; see '
            f'{_NOT_PORTED[args.dataset]}')
    if args.dataset == 'kitti':
        from .create_data_gga import kitti_data_prep
        return kitti_data_prep(args.root_path, args.out_dir,
                               workers=args.workers)
    if args.dataset == 'sunrgbd':
        return ic.create_sunrgbd_infos(args.root_path, args.out_dir,
                                       workers=args.workers,
                                       num_points=args.num_points,
                                       use_v1=args.use_v1)
    if args.dataset == 'scannet':
        return ic.create_scannet_infos(args.root_path, args.out_dir,
                                       workers=args.workers)
    return ic.create_s3dis_infos(args.root_path, args.out_dir,
                                 workers=args.workers)


if __name__ == '__main__':
    main()
