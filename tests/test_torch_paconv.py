"""The port's PAConv against gga_tpu's, f32, CPU.

- ``ScoreNet`` and one ``PAConvLayer`` in train mode on grouped
  neighbourhoods with empty slots (and one empty ball), on the weights of
  the tiny segmentor's first layer: outputs at 1e-5 of their largest
  entry, and the BatchNorm statistics after the pass (the layer's flax
  BatchNorm is unmasked: the empty slots' zeros count);
- ``paconv_regularization_loss`` (mean and sum) at rtol 1e-5;
- a tiny ``PAConvSegmentor`` (9 channels, M = 4) through
  ``test_torch_segmentor.reference_pass`` with the regulariser in the
  loss at weight 1.0: every FPS level exactly, the eval forward at 1e-5,
  the train step (logits at 1e-4 with gga_tpu's dropout mask, every loss
  term at rtol 1e-5, gradients at 1e-4 of the largest, the update).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from gga_tpu.models.backbones import paconv as jpaconv
from gga_tpu.train import optim as joptim
from gga_tpu_torch import apis, convert
from gga_tpu_torch.models.backbones import paconv as tpaconv
from tests.test_torch_groupfree3d import check_grads, update_within
from tests.test_torch_segmentor import (OPTIMIZER, TOTAL_STEPS, JaxSeg,
                                        jax_variables, port_step,
                                        reference_pass, seg_scene)
from tests.test_torch_ssd3d import close, t

torch.set_num_threads(1)

M = 4
TINY = dict(in_channels=9, num_points=(128, 32, 16, 8),
            radii=(0.4, 0.8, 1.2, 2.4), num_samples=(8, 8, 8, 4),
            sa_channels=((8,), (8, 16), (16,), (16,)),
            fp_channels=((16,), (16,), (16,), (16, 16)), num_kernels=M,
            num_classes=6, head_channels=16)


@pytest.fixture(scope='module')
def seg():
    jcfg = dataclasses.replace(jpaconv.PAConvConfig(), **TINY)
    tcfg = dataclasses.replace(tpaconv.PAConvConfig(), **TINY)
    ref = JaxSeg(jpaconv.PAConvSegmentor(jcfg),
                 jax_variables(tcfg, tpaconv.PAConvSegmentor(tcfg),
                               np.random.RandomState(3)), tcfg,
                 extra_loss=lambda p: jpaconv.paconv_regularization_loss(
                     p, M))
    inputs = seg_scene(9, seed=5)
    res = reference_pass(ref, inputs, tcfg.num_points)
    return ref, inputs, port_step(ref, res, inputs)


def _neighbourhoods(C, seed=0):
    """Grouped [2, 16, 8, C] features and offsets as ``query_and_group``
    leaves them (0 past each ball's count), ball 3 of scene 1 empty, and
    the centres."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(1, 9, (2, 16))
    counts[1, 3] = 0
    mask = np.arange(8) < counts[..., None]
    feats = np.where(mask[..., None], rng.randn(2, 16, 8, C), 0.0)
    rel = np.where(mask[..., None], rng.uniform(-0.4, 0.4, (2, 16, 8, 3)),
                   0.0)
    ctr = rng.uniform(0, 3, (2, 16, 3))
    return [x.astype(np.float32) for x in (feats, rel, ctr)] + [mask]


def _first_layer(ref):
    """gga_tpu's variables of the first PAConv layer, and the port's
    layer with the converted weights, in train mode."""
    model = tpaconv.PAConvSegmentor(ref.tcfg)
    model.load_state_dict(convert.from_jax_variables(ref.variables,
                                                     ref.tcfg))
    layer = model.backbone.SA_modules[0].mlps[0].layer0.train()
    sub = {c: ref.variables[c]['sa0']['paconv0'] for c in ref.variables}
    return sub, layer


def test_scorenet_matches_gga_tpu(seg):
    ref, _, _ = seg
    sub, layer = _first_layer(ref)
    _, rel, ctr, mask = _neighbourhoods(6)
    dist = np.sqrt((rel ** 2).sum(-1, keepdims=True))
    pair = np.concatenate([np.broadcast_to(ctr[:, :, None], rel.shape), rel,
                           dist], -1)
    net = jpaconv.ScoreNet(M)
    want, upd = jax.jit(lambda v, p, m: net.apply(
        v, p, m, True, mutable=['batch_stats']))(
        {c: sub[c]['scorenet'] for c in sub}, pair, mask)
    got = layer.scorenet(t(pair), t(mask))
    close(got, want, 1e-5)
    np.testing.assert_allclose(got.sum(-1).detach().numpy(), 1.0, rtol=1e-6)
    bn = layer.scorenet.mlps.layer1.bn
    close(bn.running_mean, upd['batch_stats']['mlp']['bn1']['mean'], 1e-5)
    close(bn.running_var, upd['batch_stats']['mlp']['bn1']['var'], 1e-5)


def test_paconv_layer_with_empty_slots_matches_gga_tpu(seg):
    ref, _, _ = seg
    sub, layer = _first_layer(ref)
    feats, rel, ctr, mask = _neighbourhoods(6, seed=1)
    jl = jpaconv.PAConvLayer(layer.out_channels, M)
    want, upd = jax.jit(lambda v, *a: jl.apply(
        v, *a, True, mutable=['batch_stats']))(sub, feats, rel, ctr, mask)
    got = layer(t(feats), t(rel), t(ctr), t(mask))
    close(got, want, 1e-5)
    # the unmasked statistics: the empty slots' outputs are not all zero
    assert bool((got[~t(mask)] != 0).any())
    close(layer.bn.running_mean, upd['batch_stats']['bn']['mean'], 1e-5)
    close(layer.bn.running_var, upd['batch_stats']['bn']['var'], 1e-5)


@pytest.mark.parametrize('reduction', ('mean', 'sum'))
def test_regularization_loss_matches_gga_tpu(seg, reduction):
    ref, _, _ = seg
    model = tpaconv.PAConvSegmentor(ref.tcfg)
    model.load_state_dict(convert.from_jax_variables(ref.variables,
                                                     ref.tcfg))
    want = float(jax.jit(lambda p: jpaconv.paconv_regularization_loss(
        p, M, reduction))(ref.variables['params']))
    got = tpaconv.paconv_regularization_loss(model, M, reduction)
    assert got.requires_grad and want > 0
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


def test_conversion_loads_strictly(seg):
    ref, _, _ = seg
    sd = convert.from_jax_variables(ref.variables, ref.tcfg)
    model = tpaconv.PAConvSegmentor(ref.tcfg)
    assert set(model.state_dict()) == set(sd)
    n_flax = sum(v.size for c in ref.variables.values()
                 for v in jax.tree_util.tree_leaves(c))
    assert sum(v.numel() for v in sd.values()) == n_flax
    model.load_state_dict(sd)
    key = 'backbone.SA_modules.1.mlps.0.layer1.'
    assert sd[key + 'weight_bank'].shape == (16, M * 16)
    assert sd[key + 'scorenet.mlps.layer2.conv.weight'].shape == (M, 16, 1, 1)
    # the last feature propagation takes the raw features (6 + 16)
    assert sd['decode_head.FP_modules.3.mlps.layer0.conv.weight'].shape == (
        16, 22, 1)


def test_eval_forward_matches_gga_tpu(seg):
    ref, inputs, res = seg
    bundle = apis.init_segmentor(
        ref.tcfg, convert.from_jax_variables(ref.variables, ref.tcfg),
        device='cpu')
    with torch.no_grad():
        got = bundle.model(t(inputs[0]), t(inputs[1]))
    close(got, res['eval'], 1e-5)
    for g, r in zip(bundle.model.last_picks, res['fps']):
        np.testing.assert_array_equal(g.numpy(), r)


def test_train_forward_matches_gga_tpu(seg):
    _, _, res = seg
    close(res['port_logits'], res['logits'], 1e-4)
    for g, r in zip(res['port_picks'], res['fps']):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize('term', ('loss_sem_seg', 'loss_regularize', 'loss'))
def test_train_step_losses_match_gga_tpu(seg, term):
    res = seg[2]
    ref, got = res['logs'], res['port_logs']
    assert set(got) == set(ref)
    np.testing.assert_allclose(float(got[term]), float(ref[term]), rtol=1e-5)


def test_train_step_gradients_match_gga_tpu(seg):
    res = seg[2]
    np.testing.assert_allclose(float(res['port_logs']['grad_norm']),
                               float(res['logs']['grad_norm']), rtol=1e-4)
    check_grads(res['ref_grads'], res['port_grads'])


def test_train_step_update_matches_gga_tpu(seg):
    res = seg[2]
    lr = float(joptim.cyclic_cos_schedule(OPTIMIZER['lr'],
                                          total_steps=TOTAL_STEPS)(0))
    update_within(res['ref_state'], res['state'], res['ref_grads'], lr,
                  OPTIMIZER['weight_decay'])


def test_width_mismatch_raises(seg):
    ref, inputs, _ = seg
    model = tpaconv.PAConvSegmentor(ref.tcfg).eval()
    with pytest.raises(ValueError, match='6 channels.*in_channels is 9'):
        model(t(inputs[0][..., :6]), t(inputs[1]))
