"""Config-dict -> detector construction through the MODELS registry (the
port's copy of ``gga_tpu/models/builder.py``: the GGA detector, the
stage-4 PGD detector and the indoor FCAF3D detector; the rest of the zoo
waits for its own slices).

``config_from_dict`` converts the python config-file dict into the typed
frozen dataclass (recursively, lists -> tuples, nested dicts -> nested
config dataclasses merged over the field default). ``MODELS.get(type)``
takes the FULL file-level Config and returns ``(model, model_cfg)``: the
port's ``GGADetector``, ``PGDDetector`` or ``FCAF3DDetector`` (weights not
yet drawn or loaded, on the CPU) and its config.
"""
from __future__ import annotations

import dataclasses

from ..config import MODELS
from .dense_heads.centerpoint_head_gga import GGAHeadConfig
from .detectors.centerpoint_gga import GGADetector, GGAModelConfig
from .detectors.fcaf3d import FCAF3DDetector, FCAF3DModelConfig
from .detectors.pgd import PGDDetector, PGDModelConfig


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
      field's default instance (partial head dicts work).
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


@MODELS.register(name='PGDDetector')
def _build_pgd(cfg):
    """The PGD config files keep the whole model in ``model``
    (``configs/_base_/models/pgd.py``)."""
    mc = config_from_dict(PGDModelConfig, dict(cfg['model']))
    return PGDDetector(mc), mc


@MODELS.register(name='FCAF3DDetector')
def _build_fcaf3d(cfg):
    """The FCAF3D config files keep the whole model in ``model``
    (``configs/_base_/models/fcaf3d.py``, the head merged over
    ``FCAF3DConfig``'s defaults)."""
    mc = config_from_dict(FCAF3DModelConfig, dict(cfg['model']))
    return FCAF3DDetector(mc), mc


def build_detector(cfg):
    """Full file-level Config -> (detector, model config)."""
    typ = cfg['model'].get('type')
    if typ is None:
        raise KeyError('cfg.model has no "type" key')
    return MODELS.get(typ)(cfg)
