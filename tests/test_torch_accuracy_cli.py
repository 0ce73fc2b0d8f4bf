"""Both accuracy CLIs of the port (``gga_tpu_torch/tools/accuracy_bench.py``
and ``accuracy_bench_stage4.py``) on the CPU.

``--device cpu`` runs (tiny, 8 synthetic scenes, 2 steps) through
``--dump-pseudo`` into stage 4: the AP keys of every eval, the stage-1 AP
of the scenes, a saved state that reloads to the same AP, a dump that
holds numpy only with the infos' keys and that gga_tpu's stage-4 bench
scores as the port's does, and repeated stage-4 evals that agree. Without
a card both CLIs raise before they write anything, and neither writes its
report over gga_tpu's ``ACCURACY*.md``.
"""
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from gga_tpu_torch.tools import accuracy_bench as tab
from gga_tpu_torch.tools import accuracy_bench_stage4 as tab4

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N_SCENES = 8
spec = importlib.util.spec_from_file_location(
    'gga_tpu_accuracy_bench_stage4', ROOT / 'tools' /
    'accuracy_bench_stage4.py')
jab4 = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jab4)


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp('accuracy')
    infos, _ = tab.make_synth_kitti(str(root), N_SCENES)
    return root, infos


def _numpy_only(x):
    if isinstance(x, dict):
        return all(_numpy_only(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_numpy_only(v) for v in x)
    return isinstance(x, (np.ndarray, np.generic, int, float, str))


def test_clis_run_on_cpu(scenes, tmp_path):
    root, infos = scenes
    dump, state = tmp_path / 'pseudo.pkl', tmp_path / 'state.pt'
    common = ['--device', 'cpu', '--cfg', 'tiny', '--scenes', str(N_SCENES),
              '--batch', '4', '--root', str(root), '--flat-lr', '--pal',
              '--dim-prior', '3.0', '--yaw-prior', '1.0', '--containment',
              '1.0', '--dump-pseudo', str(dump)]
    res = tab.main(common + ['--steps', '2', '--eval-every', '1',
                             '--save-state', str(state)])
    assert res['train_steps'] == 2 and len(res['curve']) == 2
    for key in ('stage1_labels', 'untrained', 'trained'):
        assert set(res[key]) == set(tab.AP_KEYS), key
    assert res['stage1_labels'] == tab.score_stage1_labels(infos)
    loaded = tab.main(common + ['--load-state', str(state)])
    assert loaded['trained'] == res['trained']
    with open(dump, 'rb') as f:
        pseudo = pickle.load(f)
    assert len(pseudo) == N_SCENES and _numpy_only(pseudo)
    assert set(pseudo[0]) == set(infos[0])
    assert (jab4.score_pseudo_vs_gt(pseudo, infos)
            == tab4.score_pseudo_vs_gt(pseudo, infos))

    res4 = tab4.main(['--device', 'cpu', '--root', str(root), '--pseudo',
                      str(dump), '--steps', '2', '--batch', '2',
                      '--eval-reps', '2'])
    assert res4['train_steps'] == 2
    assert res4['eval_reps'] == [res4['trained']]
    for key in ('untrained', 'trained'):
        assert set(res4[key]) == set(tab4.MONO_AP_KEYS), key


@pytest.mark.parametrize('tool', [tab, tab4], ids=['weak', 'stage4'])
def test_clis_raise_without_a_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tool.main(['--root', str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_out_refuses_gga_tpu_records():
    for name in ('ACCURACY.md', 'ACCURACY_stage4.md'):
        with pytest.raises(ValueError, match='records gga_tpu'):
            tab.check_out(str(ROOT / name))
    tab.check_out(None)
    tab.check_out(str(ROOT / 'work_dirs' / 'ACCURACY.md'))
