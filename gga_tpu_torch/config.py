"""Python-dict config system with ``_base_`` inheritance and dot-path
overrides (the port's copy of ``gga_tpu/config.py``; it reads the same
``configs/`` files).

Keeps the behavioral contract of mmcv.Config (SURVEY.md §5: python-file
configs, ``_base_`` inheritance with ``_delete_``, CLI ``--cfg-options``
dot-path overrides) without the mmcv registry machinery.
"""
from __future__ import annotations

import ast
import copy
import os
import types


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def _wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, Config):
            return Config({k: Config._wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(Config._wrap(v) for v in obj)
        return obj

    @staticmethod
    def _merge(base, new):
        """Recursive dict merge; ``_delete_: True`` in ``new`` replaces the
        base subtree entirely (mmcv semantics)."""
        if not isinstance(base, dict) or not isinstance(new, dict):
            return copy.deepcopy(new)
        if new.pop('_delete_', False):
            return copy.deepcopy(new)
        out = copy.deepcopy(base)
        for k, v in new.items():
            out[k] = Config._merge(out[k], v) if k in out else \
                copy.deepcopy(v)
        return out

    @classmethod
    def fromfile(cls, path):
        path = os.path.abspath(path)
        mod = types.ModuleType('cfg')
        mod.__file__ = path
        with open(path) as f:
            code = f.read()
        exec(compile(code, path, 'exec'), mod.__dict__)
        cfg = {k: v for k, v in mod.__dict__.items()
               if not k.startswith('_') and not isinstance(
                   v, (types.ModuleType, types.FunctionType, type))}

        bases = getattr(mod, '_base_', [])
        if isinstance(bases, str):
            bases = [bases]
        merged = {}
        for b in bases:
            bcfg = cls.fromfile(os.path.join(os.path.dirname(path), b))
            merged = cls._merge(merged, bcfg)
        merged = cls._merge(merged, cfg)
        return cls._wrap(merged)

    def merge_from_options(self, options):
        """Apply {'a.b.c': value} overrides; string values are
        literal-eval'd when possible."""
        for key, val in (options or {}).items():
            if isinstance(val, str):
                try:
                    val = ast.literal_eval(val)
                except (ValueError, SyntaxError):
                    pass
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                if p not in node or not isinstance(node[p], dict):
                    node[p] = Config()
                node = node[p]
            node[parts[-1]] = Config._wrap(val)
        return self

    def dump(self):
        import pprint
        return pprint.pformat(dict(self), width=88)


class Registry:
    """Name -> builder registry (the reference's DETECTORS/HEADS/... pattern,
    mmdet3d/models/builder.py)."""

    def __init__(self, name):
        self.name = name
        self._items = {}

    def register(self, cls=None, *, name=None):
        def deco(c):
            key = name or c.__name__
            if key in self._items:
                raise KeyError(f'{key} already registered in {self.name}')
            self._items[key] = c
            return c
        return deco(cls) if cls is not None else deco

    def get(self, key):
        if key not in self._items:
            raise KeyError(
                f'{key!r} not in {self.name} registry; '
                f'known: {sorted(self._items)}')
        return self._items[key]

    def build(self, cfg, **extra):
        cfg = dict(cfg)
        typ = cfg.pop('type')
        return self.get(typ)(**cfg, **extra)


MODELS = Registry('models')
