"""Library names from ``kernels/_build.py``, without nvcc or a card.

A library is named by a digest of its source, every shared header under
``csrc/`` and the nvcc flags, so editing any of them builds anew and an
unchanged tree loads the library already built.
"""
import pytest

from gga_tpu_torch.kernels import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / 'csrc', tmp_path / 'build'
    csrc.mkdir()
    (csrc / 'k.cu').write_text('#include "tile.cuh"\n__global__ void k() {}\n')
    (csrc / 'tile.cuh').write_text('#pragma once\n')
    monkeypatch.setattr(_build, 'CSRC', csrc)
    monkeypatch.setattr(_build, 'BUILD', build)
    return csrc


def _lib(name='k'):
    return _build._so_path(name)[1]


def test_unchanged_tree_keeps_the_library_name(tree):
    first = _lib()
    assert first.parent == _build.BUILD and first.name.startswith('libk_')
    assert _lib() == first


@pytest.mark.parametrize('edit', ['source', 'header', 'new header', 'flags'])
def test_an_edit_changes_the_library_name(tree, monkeypatch, edit):
    before = _lib()
    if edit == 'source':
        (tree / 'k.cu').write_text('__global__ void k() { return; }\n')
    elif edit == 'header':
        (tree / 'tile.cuh').write_text('#pragma once\n// changed\n')
    elif edit == 'new header':
        (tree / 'more.cuh').write_text('#pragma once\n')
    else:
        monkeypatch.setattr(_build, 'FLAGS', _build.FLAGS + ('-lineinfo',))
    assert _lib() != before


def test_a_built_library_is_not_built_again(tree):
    lib = _lib()
    lib.parent.mkdir()
    lib.write_bytes(b'')
    assert _build._start('k') is None      # no nvcc started
    assert _build.build_all(['k']).keys() == {'k'}
