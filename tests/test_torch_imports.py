"""The port stands alone: nothing under gga_tpu_torch/, nor chip_smoke.py
or f32_ablations.py, imports JAX, flax, optax, the JAX package, the
repo's tools, or Pillow (the machine with the card has none; the port
reads PNGs with its own ``data/kitti/png.py``)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'gga_tpu', 'tools', 'PIL')
FILES = sorted((ROOT / 'gga_tpu_torch').rglob('*.py')) + [
    ROOT / 'chip_smoke.py', ROOT / 'f32_ablations.py']


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


@pytest.mark.parametrize('path', FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{path.relative_to(ROOT)} imports {bad}'


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert 'gga_tpu_torch/kernels/sparse_conv.py' in names
    assert 'chip_smoke.py' in names
    # the data-parallel package and the top-level entry points
    assert {'gga_tpu_torch/parallel/__init__.py',
            'gga_tpu_torch/parallel/mesh.py',
            'gga_tpu_torch/parallel/dist_eval.py',
            'gga_tpu_torch/entry.py'} <= names
