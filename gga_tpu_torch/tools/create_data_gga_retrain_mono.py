"""Stage-4 data preparation: mono3D COCO jsons of the pseudo-info pkls (the
port's copy of ``tools/create_data_gga_retrain_mono.py``; host code only).

After stage 3 has written ``<tag>_infos_trainval_GGA_pseudo.pkl``
(``tools/generate_pseudo_labels_gga``), this writes the
``*_mono3d.coco.json`` files the monocular retrain reads, beside the pkls,
for the pseudo trainval split and the test split; a missing pkl is
skipped.

Usage:
    python -m gga_tpu_torch.tools.create_data_gga_retrain_mono kitti \\
        --root-path data/kitti [--extra-tag kitti]
"""
from __future__ import annotations

import argparse
import os
import pickle

from ..data.kitti.mono_export import export_mono3d_coco


def export_for(info_path):
    """The json of one pkl: dict(pkl, json, images, annotations), or None
    if the pkl is missing."""
    if not os.path.exists(info_path):
        print(f'skip (missing): {info_path}')
        return None
    with open(info_path, 'rb') as f:
        infos = pickle.load(f)
    out = info_path.replace('.pkl', '_mono3d.coco.json')
    coco = export_mono3d_coco(infos, out)
    print(f'wrote {out} ({len(infos)} images)')
    return dict(pkl=info_path, json=out, images=len(coco['images']),
                annotations=len(coco['annotations']))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('dataset', choices=['kitti'], help='dataset name (kitti)')
    p.add_argument('--root-path', default='./data/kitti')
    p.add_argument('--out-dir', default=None,
                   help='unused; the jsons are written beside the pkls')
    p.add_argument('--extra-tag', default='kitti',
                   help='info file name prefix')
    return p.parse_args(argv)


def main(argv=None):
    """Returns {split: export_for's dict or None} for 'trainval_pseudo'
    and 'test'."""
    args = parse_args(argv)
    root, tag = args.root_path, args.extra_tag
    return {
        'trainval_pseudo': export_for(os.path.join(
            root, f'{tag}_infos_trainval_GGA_pseudo.pkl')),
        'test': export_for(os.path.join(root, f'{tag}_infos_test.pkl')),
    }


if __name__ == '__main__':
    main()
