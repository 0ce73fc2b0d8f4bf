"""The port's DGCNN against gga_tpu's, f32, CPU.

- ``masked_knn_graph`` on the same features: D-KNN (3 channels) and F-KNN
  at widths on both sides of XLA's 32-wide reduction windows, with
  padding and a scene of fewer valid points than k, picks exactly equal
  to ``jax.lax.top_k``'s; the graph built in blocks of scenes and query
  rows equal index for index to the one built in one pass;
- a tiny ``DGCNNSegmentor`` (9 channels, k = 8, the third GF module keyed
  on 40-wide features) through ``test_torch_segmentor.reference_pass``,
  given gga_tpu's graphs (each GF module's ``masked_knn_graph`` on its
  captured input): the eval forward at 1e-5, the train step (logits at
  1e-4 with gga_tpu's dropout mask, losses at rtol 1e-5, gradients at
  1e-4 of the largest, the update). The graphs the port builds on its own
  features equal gga_tpu's but for near ties (a relative distance gap of
  5e-7 in this scene: the features differ in their last bits), as on
  the card; at least 99.9 % of the entries equal.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gga_tpu.models.backbones import dgcnn as jdgcnn
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.backbones import dgcnn as tdgcnn
from tests.test_torch_groupfree3d import check_grads, update_within
from tests.test_torch_segmentor import (OPTIMIZER, TOTAL_STEPS, JaxSeg,
                                        jax_variables, port_step,
                                        reference_pass, seg_scene)
from tests.test_torch_ssd3d import close, t

torch.set_num_threads(1)

K = 8
TINY = dict(in_channels=9, num_samples=(K, K, K),
            gf_channels=((8, 8), (40,), (8,)), fa_channels=(32,),
            num_classes=6, fp_channels=(16,), head_channels=16)


def jax_graph(feats, valid, k):
    return np.asarray(jax.jit(jax.vmap(jdgcnn.masked_knn_graph,
                                       (0, 0, None)), static_argnums=2)(
        feats, valid, k))


def knn_features(D, seed):
    """[3, 96, D] features (two rows equal, a near-duplicate) and their
    valid mask: the second scene with 20 padded points, the third with 5
    valid points, fewer than k."""
    rng = np.random.RandomState(seed)
    f = (rng.randn(3, 96, D) * 2).astype(np.float32)
    f[:, 7] = f[:, 3]
    f[:, 9] = f[:, 3] + 1e-6
    valid = np.ones((3, 96), bool)
    valid[1, -20:] = False
    valid[2, 5:] = False
    return f, valid


@pytest.mark.parametrize('D', (3, 16, 32, 40, 64, 67))
def test_knn_picks_match_gga_tpu(D):
    f, valid = knn_features(D, D)
    want = jax_graph(f, valid, K)
    got = tdgcnn.masked_knn_graph(t(f), t(valid), K)
    np.testing.assert_array_equal(got.numpy(), want)
    # the scene of 5 valid points takes them, then padding in index order
    assert set(got[2, 0, :5].tolist()) == set(range(5))
    np.testing.assert_array_equal(got[2, 0, 5:].numpy(), np.arange(5, K))


@pytest.mark.parametrize('budget', (96 * 40, 96 * 96 * 2 + 7))
def test_blocked_graph_equals_unblocked(budget, monkeypatch):
    """Blocks of 40 query rows of one scene, or two scenes a pass."""
    f, valid = knn_features(40, 1)
    whole = tdgcnn.masked_knn_graph(t(f), t(valid), K)
    monkeypatch.setattr(tdgcnn, 'KNN_ELEMENTS', budget)
    blocked = tdgcnn.masked_knn_graph(t(f), t(valid), K)
    assert torch.equal(blocked, whole)


def _graph_inputs(points, inter, knn_modes):
    """Each GF module's kNN key and input, from gga_tpu's captured GF
    outputs."""
    outs = [inter['backbone'][f'gf{i}']['__call__'][0]
            for i in range(len(knn_modes))]
    ins = [points] + outs[:-1]
    return [x[..., -3:] if m == 'D-KNN' else x
            for x, m in zip(ins, knn_modes)]


@pytest.fixture(scope='module')
def seg():
    jcfg = dataclasses.replace(jdgcnn.DGCNNConfig(), **TINY)
    tcfg = dataclasses.replace(tdgcnn.DGCNNConfig(), **TINY)
    ref = JaxSeg(jdgcnn.DGCNNSegmentor(jcfg),
                 jax_variables(tcfg, tdgcnn.DGCNNSegmentor(tcfg),
                               np.random.RandomState(2)), tcfg,
                 capture=lambda m, _: isinstance(m, jdgcnn.DGCNNGFModule))
    inputs = seg_scene(9, seed=4)
    res = reference_pass(ref, inputs, None)
    res['graphs'], res['train_graphs'] = (
        [jax_graph(k, inputs[1], K) for k in _graph_inputs(
            inputs[0], inter, tcfg.knn_modes)]
        for inter in (res['inter'], res['train_inter']))
    return ref, inputs, port_step(ref, res, inputs,
                                  [t(g) for g in res['train_graphs']])


def test_conversion_loads_strictly(seg):
    ref, _, _ = seg
    sd = convert.from_jax_variables(ref.variables, ref.tcfg)
    model = tdgcnn.DGCNNSegmentor(ref.tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in ref.variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)
    assert sd['backbone.GF_modules.0.mlps.layer0.conv.weight'].shape == (
        8, 18, 1, 1)
    assert sd['decode_head.FP_module.mlps.layer0.conv.weight'].shape == (
        16, 32 + 8 + 40 + 8, 1)


def test_eval_forward_matches_gga_tpu(seg):
    ref, inputs, res = seg
    bundle = apis.init_segmentor(
        ref.tcfg, convert.from_jax_variables(ref.variables, ref.tcfg),
        device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]),
                           picks=[t(g) for g in res['graphs']])
        close(got, res['eval'], 1e-5)
        bundle.model(t(inputs[0]), t(inputs[1]))
    own = bundle.model.last_picks
    assert len(own) == 3
    np.testing.assert_array_equal(own[0].numpy(), res['graphs'][0])
    same = np.mean([(g.numpy() == r).mean()
                    for g, r in zip(own, res['graphs'])])
    assert same >= 0.999, same
    # the padded points' neighbours are the scene's valid points only
    assert bool(t(inputs[1]).gather(1, own[1][1].reshape(1, -1)).all())


def test_train_forward_matches_gga_tpu(seg):
    _, _, res = seg
    close(res['port_logits'], res['logits'], 1e-4)


def test_train_step_losses_match_gga_tpu(seg):
    res = seg[2]
    ref, got = res['logs'], res['port_logs']
    assert set(got) == set(ref)
    for k in ('loss_sem_seg', 'loss'):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(got['grad_norm']),
                               float(ref['grad_norm']), rtol=1e-4)


def test_train_step_gradients_match_gga_tpu(seg):
    check_grads(seg[2]['ref_grads'], seg[2]['port_grads'])


def test_train_step_update_matches_gga_tpu(seg):
    from gga_tpu.train import optim as joptim
    res = seg[2]
    lr = float(joptim.cyclic_cos_schedule(OPTIMIZER['lr'],
                                          total_steps=TOTAL_STEPS)(0))
    update_within(res['ref_state'], res['state'], res['ref_grads'], lr,
                  OPTIMIZER['weight_decay'])


def test_graphs_are_given_back(seg):
    ref, inputs, res = seg
    model = tdgcnn.DGCNNSegmentor(ref.tcfg).eval()
    model.load_state_dict(convert.from_jax_variables(ref.variables,
                                                     ref.tcfg))
    with torch.no_grad():
        first = model(t(inputs[0]), t(inputs[1]))
        given = model.last_picks
        assert torch.equal(model(t(inputs[0]), t(inputs[1]), picks=given),
                           first)
        other = [torch.roll(g, 1, -1) for g in given]
        other[0] = torch.roll(given[0], 1, 1)
        assert not torch.equal(
            model(t(inputs[0]), t(inputs[1]), picks=other), first)


def test_width_mismatch_raises(seg):
    ref, inputs, _ = seg
    model = tdgcnn.DGCNNSegmentor(ref.tcfg).eval()
    with pytest.raises(ValueError, match='6 channels.*in_channels is 9'):
        model(t(inputs[0][..., :6]), t(inputs[1]))
