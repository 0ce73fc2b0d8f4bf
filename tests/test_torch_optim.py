"""The port's optimizer against gga_tpu's optax chain, on the CPU.

From the same parameters and the same gradients, the port's clip + AdamW
must give gga_tpu's ``tx.update`` + ``apply_updates`` at rtol 1e-6 over
three steps, with the clip active and inactive, and the same lr and beta1
at each step. The schedules must agree at the ends of their phases at
rtol 1e-6 plus two float32 ulps of the schedule's peak: gga_tpu computes
them in float32, the port in float64, and where the cosine nears -1 the
annealed term is small beside its float32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gga_tpu.train import optim as jopt
from gga_tpu_torch.train import optim as topt

torch.set_num_threads(1)


@pytest.mark.parametrize('total', [100, 10000])
@pytest.mark.parametrize('base,ratio', [(1.5e-3, (10, 1e-4)),
                                        (0.95, (0.8947368421052632, 1.0))])
def test_cyclic_cos_schedule_matches_gga_tpu(total, base, ratio):
    up_len = int(total * 0.4)
    ref = jopt.cyclic_cos_schedule(base, ratio, 0.4, total)
    out = topt.cyclic_cos_schedule(base, ratio, 0.4, total)
    peak = base * max(ratio)
    for step in (0, 1, up_len - 1, up_len, up_len + 1, total - 1, total):
        np.testing.assert_allclose(out(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6, atol=2 ** -22 * peak,
                                   err_msg=f'step {step}')


@pytest.mark.parametrize('grad_scale', [1.0, 300.0])
def test_clip_and_adamw_match_optax(grad_scale):
    """grad_scale 300 puts the global norm above the clip of 35."""
    rng = np.random.RandomState(0)
    shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = jopt.build_optimizer(total_steps=20)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = topt.build_optimizer(tp.values(), total_steps=20)
    for g in grads:
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=1e-6)
        assert (float(norm) >= 35.0) == (grad_scale > 1)
        hp = state[1].hyperparams
        group = opt.adamw.param_groups[0]
        np.testing.assert_allclose(group['lr'], float(hp['learning_rate']),
                                   rtol=1e-6)
        np.testing.assert_allclose(group['betas'][0], float(hp['b1']),
                                   rtol=1e-6)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert opt.count == 3


def test_flat_clip_and_adamw_match_optax():
    """``cyclic=False`` (the accuracy bench's ``--flat-lr``): the lr and
    beta1 stay at their base values, and three clipped AdamW steps equal
    gga_tpu's ``build_optimizer(cyclic=False)`` at rtol 1e-6. The clip is
    active at the first step and not at the last."""
    rng = np.random.RandomState(1)
    shapes = {'a': (4, 3), 'b': (5,), 'c': (2, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (300.0, 30.0, 1.0)]
    lr = 2e-4

    tx = jopt.build_optimizer(total_steps=20, lr=lr, cyclic=False)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state, optax.global_norm(g)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = topt.build_optimizer(tp.values(), total_steps=20, lr=lr,
                               cyclic=False)
    norms = []
    for g in grads:
        jp, state, jnorm = update({k: jnp.asarray(v) for k, v in g.items()},
                                  state, jp)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = opt.step()
        norms.append(float(norm))
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        hp = state[1].hyperparams
        group = opt.adamw.param_groups[0]
        assert group['lr'] == lr and group['betas'] == (0.95, 0.99)
        np.testing.assert_allclose(float(hp['learning_rate']), lr,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(hp['b1']), 0.95, rtol=1e-6)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert norms[0] >= 35.0 > norms[-1]
    assert [opt.lr_schedule(s) for s in (0, 7, 10 ** 6)] == [lr] * 3
    assert opt.count == 3
