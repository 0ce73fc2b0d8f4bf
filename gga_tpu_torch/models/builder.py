"""Config-dict -> detector construction through the MODELS registry (the
port's copy of ``gga_tpu/models/builder.py``: the GGA detector, the
stage-4 PGD detector, the indoor FCAF3D detector, the fully supervised
KITTI voxel detectors: SECOND, PointPillars, DynamicVoxelNet, DVSECOND and
SASSD and the two-stage PartA2, the nuScenes and Lyft pillar detectors
(PointPillars with the RegNet backbones, the FPN neck and bf16,
FreeAnchor of ``configs/free_anchor/`` and SSN of ``configs/ssn/``), the fully supervised nuScenes
CenterPoint of ``configs/centerpoint/``, the indoor VoteNet of
``configs/votenet/``, the point-based KITTI detectors 3DSSD
(``configs/3dssd/``) and PointRCNN (``configs/point_rcnn/``) and the
VoteNet-derived indoor detectors GroupFree3D (``configs/groupfree3d/``),
H3DNet (``configs/h3dnet/``) and ImVoteNet (``configs/imvotenet/``), and
the point-cloud segmentors: the PointNet++ EncoderDecoder3D
(``configs/pointnet2/``), DGCNN (``configs/dgcnn/``) and PAConv
(``configs/paconv/``), and the image-fusion and image-to-voxel detectors
MVXNet (``configs/mvxnet/``), ImVoxelNet and ImVoxelNetIndoor
(``configs/imvoxelnet/``); the rest of the zoo waits for its own
slices).

A segmentor's weights are shaped by its config's ``in_channels`` (flax
infers a layer's width from its first input), and it refuses a cloud of
another width by name: the S3DIS DGCNN, PAConv and PointNet2-MSG configs
declare 9 channels (mmdet3d's xyz | rgb | normalised xyz), while
``S3DISSegDataset`` loads 6.

``config_from_dict`` converts the python config-file dict into the typed
frozen dataclass (recursively, lists -> tuples, nested dicts -> nested
config dataclasses merged over the field default). ``MODELS.get(type)``
takes the FULL file-level Config and returns ``(model, model_cfg)``: the
port's detector of that type (weights not yet drawn or loaded, on the
CPU) and its config. Only the ``model`` block builds a detector: the
top-level ``tta`` block of the CenterPoint tta configs is read by neither
package.
"""
from __future__ import annotations

import dataclasses

from ..config import MODELS
from .dense_heads.centerpoint_head_gga import GGAHeadConfig
from .detectors.centerpoint_gga import GGADetector, GGAModelConfig
from .detectors.centerpoint import CenterPointConfig, CenterPointDetector
from .detectors.dynamic_voxelnet import (DVSECONDConfig, DVSECONDDetector,
                                         DynamicVoxelNet,
                                         DynamicVoxelNetConfig)
from .detectors.fcaf3d import FCAF3DDetector, FCAF3DModelConfig
from .detectors.groupfree3d import GroupFree3DNet, GroupFree3DNetConfig
from .detectors.h3dnet import H3DNet, H3DNetConfig
from .detectors.imvotenet import ImVoteNet, ImVoteNetConfig
from .detectors.imvoxelnet import (ImVoxelNet, ImVoxelNetConfig,
                                   ImVoxelNetIndoor, ImVoxelNetIndoorConfig)
from .detectors.mvxnet import MVXNet, MVXNetConfig
from .detectors.parta2 import PartA2Config, PartA2Detector
from .detectors.pgd import PGDDetector, PGDModelConfig
from .detectors.point_rcnn import PointRCNNConfig, PointRCNNDetector
from .detectors.sassd import SASSD, SASSDConfig
from .detectors.ssn import SSNConfig, SSNDetector
from .detectors.ssd3d import SSD3DNet, SSD3DNetConfig
from .detectors.votenet import VoteNet, VoteNetConfig
from .detectors.voxelnet import (FreeAnchorPointPillarsConfig, PointPillars,
                                 PointPillarsConfig, SECONDDetector,
                                 SECONDNetConfig, refuse_pillars_bf16)
from .backbones.dgcnn import DGCNNConfig, DGCNNSegmentor
from .backbones.paconv import PAConvConfig, PAConvSegmentor
from .segmentors.encoder_decoder import (EncoderDecoder3D,
                                         EncoderDecoder3DConfig)


def _tuplify(v):
    if isinstance(v, (list, tuple)):
        return tuple(_tuplify(x) for x in v)
    return v


def config_from_dict(cfg_cls, d, base=None):
    """Build a frozen dataclass config from a plain dict.

    - unknown keys raise (catches config typos, like the registry's
      strict ``**cfg`` expansion in the reference builder);
    - lists become (nested) tuples so configs stay hashable;
    - a dict value for a dataclass-typed field is merged OVER the
      field's default instance (partial head dicts work);
    - a list of dicts for a tuple-of-dataclass field builds one element
      of the default's element type from each.
    """
    base = cfg_cls() if base is None else base
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    kwargs = {}
    for k, v in d.items():
        if k == 'type':
            continue
        if k not in fields:
            raise KeyError(
                f'{cfg_cls.__name__} has no field {k!r}; '
                f'known: {sorted(fields)}')
        cur = getattr(base, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            kwargs[k] = config_from_dict(type(cur), v, base=cur)
        elif (isinstance(cur, tuple) and cur
              and dataclasses.is_dataclass(cur[0])
              and isinstance(v, (list, tuple))
              and all(isinstance(x, dict) for x in v)):
            # a tuple-of-dataclass field (H3DNet's primitive heads): each
            # dict builds an element of the default's element type
            kwargs[k] = tuple(type(cur[0])(**{ek: _tuplify(ev)
                                              for ek, ev in x.items()})
                              for x in v)
        else:
            kwargs[k] = _tuplify(v)
    return dataclasses.replace(base, **kwargs)


@MODELS.register(name='GGADetector')
def _build_gga(cfg):
    """GGA config files keep ``head`` and ``test_cfg`` as top-level
    blocks (mirroring the reference's train_cfg/test_cfg split at
    configs/gga/gga_kitti_config.py:63-91)."""
    d = {k: v for k, v in cfg['model'].items() if k != 'type'}
    if 'head' in cfg:
        d['head'] = config_from_dict(GGAHeadConfig, dict(cfg['head']))
    for k in ('max_per_task', 'score_threshold', 'nms_thr',
              'post_max_size'):
        if 'test_cfg' in cfg and k in cfg['test_cfg']:
            d[k] = cfg['test_cfg'][k]
    mc = config_from_dict(GGAModelConfig, d)
    return GGADetector(mc), mc


def _register_family(name, cfg_cls, model_cls, check=None):
    """A type whose config files keep the whole model in ``model`` (the
    head merged over its config's defaults), as gga_tpu's families;
    ``check(model_cfg)`` may refuse a config before the build."""
    @MODELS.register(name=name)
    def _build(cfg):
        mc = config_from_dict(cfg_cls, dict(cfg['model']))
        if check is not None:
            check(mc)
        return model_cls(mc), mc
    _build.__name__ = f'build_{name}'
    return _build


_register_family('PGDDetector', PGDModelConfig, PGDDetector)
_register_family('FCAF3DDetector', FCAF3DModelConfig, FCAF3DDetector)
_register_family('PointPillars', PointPillarsConfig, PointPillars,
                 refuse_pillars_bf16)
_register_family('FreeAnchorPointPillars', FreeAnchorPointPillarsConfig,
                 PointPillars, refuse_pillars_bf16)
_register_family('SSNDetector', SSNConfig, SSNDetector)
_register_family('SECONDDetector', SECONDNetConfig, SECONDDetector)
_register_family('DVSECONDDetector', DVSECONDConfig, DVSECONDDetector)
_register_family('DynamicVoxelNet', DynamicVoxelNetConfig, DynamicVoxelNet)
_register_family('SASSD', SASSDConfig, SASSD)
_register_family('PartA2Detector', PartA2Config, PartA2Detector)
_register_family('CenterPointDetector', CenterPointConfig, CenterPointDetector)
_register_family('VoteNet', VoteNetConfig, VoteNet)
_register_family('PointRCNNDetector', PointRCNNConfig, PointRCNNDetector)
_register_family('SSD3DNet', SSD3DNetConfig, SSD3DNet)
_register_family('GroupFree3DNet', GroupFree3DNetConfig, GroupFree3DNet)
_register_family('H3DNet', H3DNetConfig, H3DNet)
_register_family('ImVoteNet', ImVoteNetConfig, ImVoteNet)
_register_family('EncoderDecoder3D', EncoderDecoder3DConfig,
                 EncoderDecoder3D)
_register_family('DGCNNSegmentor', DGCNNConfig, DGCNNSegmentor)
_register_family('PAConvSegmentor', PAConvConfig, PAConvSegmentor)
_register_family('MVXNet', MVXNetConfig, MVXNet)
_register_family('ImVoxelNet', ImVoxelNetConfig, ImVoxelNet)
_register_family('ImVoxelNetIndoor', ImVoxelNetIndoorConfig,
                 ImVoxelNetIndoor)


def build_detector(cfg):
    """Full file-level Config -> (detector, model config)."""
    typ = cfg['model'].get('type')
    if typ is None:
        raise KeyError('cfg.model has no "type" key')
    return MODELS.get(typ)(cfg)
