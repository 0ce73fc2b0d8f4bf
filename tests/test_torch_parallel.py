"""The port's ``parallel`` package on the CPU: the sharded-eval collect,
the process shards, the one-process no-ops, and the batch norms at two
``gloo`` ranks.

- ``shard_indices`` / ``dump_part`` / ``collect_parts`` in the mould of
  tests/test_train/test_dist_eval.py, and ``process_shard`` against
  gga_tpu's, exactly.
- ``MaskedBatchNorm`` and ``BatchNorm2d`` at two ranks, each on its rows
  of a global batch of 4: the output, the running statistics (the
  moments) and the gradients against the port's one-process layer on the
  whole batch within 1e-6, and the output and running statistics against
  gga_tpu's layer on a 2-device mesh (conftest forces 8 CPU devices)
  within 1e-5.
- With no group the layers give the bits of their one-process formulas
  (the parent commit's code, written out here): output, statistics and
  gradients.

The ranks are processes started with ``spawn`` and joined through a
FileStore under ``tmp_path`` (no port, no network). JAX is imported
inside the tests only, so a spawned rank imports torch and the port.
"""
import os

import numpy as np
import pytest
import torch

from gga_tpu_torch.models import layers
from gga_tpu_torch.parallel import dist_eval, mesh

torch.set_num_threads(1)

B, N, C, H, W = 4, 64, 8, 6, 10


def _rank_main(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    mesh.init_distributed(f'file://{os.path.join(tmp, "store")}', world,
                          rank, 'gloo')
    try:
        fn(rank, world, tmp, *args)
    finally:
        mesh.shutdown()


def start_ranks(fn, world, tmp, *args):
    """``fn(rank, world, tmp, *args)`` in ``world`` spawned gloo ranks of
    one group (a FileStore under ``tmp``); returns the context to join."""
    return torch.multiprocessing.spawn(
        _rank_main, args=(fn, world, str(tmp), args), nprocs=world,
        join=False)


def join_ranks(ctx):
    """Wait for every rank; a rank's failure raises here."""
    while not ctx.join():
        pass


# --- the sharded-eval collect and the process shards ------------------------

@pytest.mark.parametrize('case', ['partition', 'roundtrip', 'size_mismatch',
                                  'timeout'])
def test_dist_eval_collect(case, tmp_path):
    from gga_tpu.parallel import dist_eval as jdist

    n, world = 23, 4
    if case == 'partition':
        for r in range(world):
            assert (dist_eval.shard_indices(n, r, world)
                    == jdist.shard_indices(n, r, world))
        assert sorted(sum((dist_eval.shard_indices(n, r, world)
                           for r in range(world)), [])) == list(range(n))
    elif case == 'roundtrip':
        data = [{'scene': i, 'boxes': [i * 1.0]} for i in range(n)]
        for r in range(world):
            dist_eval.dump_part(
                [data[i] for i in dist_eval.shard_indices(n, r, world)], r,
                str(tmp_path))
        assert dist_eval.collect_parts(n, world, str(tmp_path),
                                       timeout_s=5) == data
        # the files are gga_tpu's: its collect reads the same merge
        assert jdist.collect_parts(n, world, str(tmp_path),
                                   timeout_s=5) == data
    elif case == 'size_mismatch':
        dist_eval.dump_part([1, 2, 3], 0, str(tmp_path))
        dist_eval.dump_part([1], 1, str(tmp_path))
        with pytest.raises(ValueError, match='expected'):
            dist_eval.collect_parts(4, 2, str(tmp_path), timeout_s=5)
    else:
        dist_eval.dump_part([1, 2], 0, str(tmp_path))
        with pytest.raises(TimeoutError):
            dist_eval.collect_parts(4, 2, str(tmp_path), timeout_s=0.2,
                                    poll_s=0.05)


@pytest.mark.parametrize('n,world', [(23, 4), (8, 2), (5, 8), (1, 3)])
def test_process_shard_matches_gga_tpu(n, world):
    from gga_tpu.parallel import mesh as jmesh

    order = np.random.RandomState(n).permutation(n)
    for r in range(world):
        np.testing.assert_array_equal(mesh.process_shard(order, world, r),
                                      jmesh.process_shard(order, world, r))


def test_one_process_is_a_no_op(tmp_path):
    """No group: init_distributed does nothing for one process, the
    reductions are the identity, and a backend this build lacks raises
    instead of being swapped for another."""
    assert mesh.init_distributed(None, 1, 0, 'gloo') is False
    assert mesh.init_distributed() is False
    assert (mesh.world_size(), mesh.rank(), mesh.distributed()) == (1, 0,
                                                                    False)
    t = torch.randn(3, requires_grad=True)
    assert mesh.global_sum(t) is t
    assert mesh.sum_over_ranks([t]) == [t]
    assert torch.equal(mesh.global_mean(t), t.mean())
    t.sum().backward()
    g = t.grad.clone()
    mesh.all_reduce_grads([t])
    assert torch.equal(t.grad, g)
    batch = dict(a=np.arange(8).reshape(4, 2), b=torch.arange(4))
    half = mesh.shard_rows(batch, 1, 2)
    np.testing.assert_array_equal(half['a'], [[4, 5], [6, 7]])
    assert half['b'].tolist() == [2, 3]
    with pytest.raises(ValueError, match='split'):
        mesh.shard_rows(batch, 0, 3)
    with pytest.raises(ValueError, match='backend'):
        mesh.init_distributed('file:///nowhere', 2, 0, None)
    if not torch.distributed.is_nccl_available():
        with pytest.raises(RuntimeError, match='nccl'):
            mesh.init_distributed(f'file://{tmp_path}/store', 2, 0, 'nccl')
    assert not torch.distributed.is_initialized()


# --- the batch norms at two ranks --------------------------------------------

def _bn_inputs():
    rng = np.random.RandomState(0)
    xm = (rng.randn(B, N, C) * 2 + 0.5).astype(np.float32)
    valid = rng.rand(B, N) < 0.7
    valid[1] = False                            # a scene with no site
    xd = (rng.randn(B, C, H, W) * 3 - 1).astype(np.float32)
    gm = rng.randn(B, N, C).astype(np.float32)
    gd = rng.randn(B, C, H, W).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, (2, C)).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, (2, C)).astype(np.float32)
    return xm, valid, xd, gm, gd, scale, bias


def _bn_pass(rows=slice(None)):
    """Both layers in train mode on ``rows`` of the global batch: the
    outputs, the input gradients of sum(y * g), the running statistics
    and the parameter gradients (summed over the ranks)."""
    xm, valid, xd, gm, gd, scale, bias = _bn_inputs()
    out = {}
    for name, layer, x, g, extra in (
            ('masked', layers.MaskedBatchNorm(C), xm, gm, (valid,)),
            ('dense', layers.BatchNorm2d(C), xd, gd, ())):
        i = 0 if name == 'masked' else 1
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(scale[i]))
            layer.bias.copy_(torch.from_numpy(bias[i]))
        layer.train()
        xt = torch.from_numpy(x[rows]).requires_grad_()
        y = layer(xt, *(torch.from_numpy(e[rows]) for e in extra))
        (y * torch.from_numpy(g[rows])).sum().backward()
        mesh.all_reduce_grads(layer.parameters())
        out[name] = dict(y=y.detach(), dx=xt.grad,
                         mean=layer.running_mean.clone(),
                         var=layer.running_var.clone(),
                         dw=layer.weight.grad, db=layer.bias.grad)
    return out


def _bn_rank(rank, world, tmp):
    b = B // world
    torch.save(_bn_pass(slice(rank * b, (rank + 1) * b)),
               os.path.join(tmp, f'bn_{rank}.pt'))


def _jax_bn():
    """gga_tpu's MaskedBatchNorm and BatchNorm2d (NHWC) in train mode on
    a 2-device mesh, the batch sharded on axis 0: outputs and updated
    statistics."""
    import jax
    import jax.numpy as jnp

    from gga_tpu.models import layers as jlayers
    from gga_tpu.parallel import mesh as jmesh

    xm, valid, xd, _, _, scale, bias = _bn_inputs()
    m = jmesh.data_parallel_mesh(jax.devices()[:2])
    out = {}
    for name, model, args in (
            ('masked', jlayers.MaskedBatchNorm(), (xm, valid)),
            ('dense', jlayers.BatchNorm2d(), (xd.transpose(0, 2, 3, 1),))):
        i = 0 if name == 'masked' else 1
        shapes = jax.eval_shape(lambda: model.init(
            jax.random.PRNGKey(0), *args, train=True))

        def fill(tree, path=()):
            if hasattr(tree, 'items'):
                return {k: fill(v, path + (k,)) for k, v in tree.items()}
            return dict(scale=scale[i], bias=bias[i], mean=np.zeros(C),
                        var=np.ones(C))[path[-1]].astype(np.float32)

        variables = fill({c: shapes[c] for c in ('params', 'batch_stats')})

        def apply(v, *a, model=model):
            return model.apply(v, *a, train=True, mutable=['batch_stats'])

        with m:
            y, upd = jax.jit(apply, in_shardings=(
                jmesh.replicate(m),
                *(jmesh.batch_sharding(m) for _ in args)))(
                    variables, *map(jnp.asarray, args))
        stats = jax.tree_util.tree_leaves_with_path(upd['batch_stats'])
        stats = {p[-1].key: np.asarray(v) for p, v in stats}
        y = np.asarray(y)
        out[name] = dict(y=y if name == 'masked' else y.transpose(0, 3, 1, 2),
                         mean=stats['mean'], var=stats['var'])
    return out


@pytest.fixture(scope='module')
def bn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('bn_ranks')
    ctx = start_ranks(_bn_rank, 2, tmp)
    one, jax_ref = _bn_pass(), _jax_bn()
    join_ranks(ctx)
    ranks = [torch.load(tmp / f'bn_{r}.pt') for r in range(2)]
    return one, ranks, jax_ref


@pytest.mark.parametrize('name', ['masked', 'dense'])
def test_bn_two_ranks_match_one_process(bn, name):
    one, ranks, _ = bn
    one, ranks = one[name], [r[name] for r in ranks]
    for key in ('y', 'dx'):
        got = torch.cat([r[key] for r in ranks]).numpy()
        np.testing.assert_allclose(got, one[key].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    for key in ('mean', 'var', 'dw', 'db'):
        # every rank holds the global value
        for r in ranks:
            np.testing.assert_allclose(r[key].numpy(), one[key].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    assert torch.equal(ranks[0]['mean'], ranks[1]['mean'])
    assert torch.equal(ranks[0]['var'], ranks[1]['var'])


@pytest.mark.parametrize('name', ['masked', 'dense'])
def test_bn_two_ranks_match_gga_tpu_mesh(bn, name):
    _, ranks, jax_ref = bn
    ranks, ref = [r[name] for r in ranks], jax_ref[name]
    got = torch.cat([r['y'] for r in ranks]).numpy()
    np.testing.assert_allclose(got, ref['y'], rtol=1e-5, atol=1e-5)
    for key in ('mean', 'var'):
        for r in ranks:
            np.testing.assert_allclose(r[key].numpy(), ref[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)


def _one_process_formula(name, layer, x, extra):
    """The layers' train-mode arithmetic in one process, as written
    before the process groups (the bits every existing test holds)."""
    xf = x.float()
    if name == 'masked':
        valid = extra[0]
        m = valid[..., None].float()
        dims = tuple(range(x.dim() - 1))
        cnt = m.sum().clamp(min=1.0)
        mean = (xf * m).sum(dims) / cnt
        var = (((xf - mean) ** 2) * m).sum(dims) / cnt
        with torch.no_grad():
            layer.running_mean.lerp_(mean, layer.momentum)
            layer.running_var.lerp_(var * cnt / (cnt - 1).clamp(min=1.0),
                                    layer.momentum)
        y = ((xf - mean) * torch.rsqrt(var + layer.eps) * layer.weight
             + layer.bias)
        return torch.where(valid[..., None], y, 0.0).to(x.dtype)
    mean = xf.mean((0, 2, 3))
    var = xf.var((0, 2, 3), unbiased=False)
    with torch.no_grad():
        layer.running_mean.lerp_(mean, layer.momentum)
        layer.running_var.lerp_(var, layer.momentum)
    mul = torch.rsqrt(var + layer.eps) * layer.weight
    y = (xf - mean[:, None, None]) * mul[:, None, None] \
        + layer.bias[:, None, None]
    return y.to(x.dtype)


@pytest.mark.parametrize('name', ['masked', 'dense'])
def test_bn_one_process_bits_unchanged(name):
    xm, valid, xd, gm, gd, scale, bias = _bn_inputs()
    x, g, extra = ((xm, gm, (torch.from_numpy(valid),)) if name == 'masked'
                   else (xd, gd, ()))
    res = []
    for formula in (False, True):
        layer = (layers.MaskedBatchNorm(C) if name == 'masked'
                 else layers.BatchNorm2d(C)).train()
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(scale[0]))
            layer.bias.copy_(torch.from_numpy(bias[0]))
        xt = torch.from_numpy(x).requires_grad_()
        y = (_one_process_formula(name, layer, xt, extra) if formula
             else layer(xt, *extra))
        (y * torch.from_numpy(g)).sum().backward()
        res.append([y.detach(), xt.grad, layer.running_mean,
                    layer.running_var, layer.weight.grad, layer.bias.grad])
    for a, b in zip(*res):
        assert torch.equal(a, b)


def test_shard_rows_is_the_samplers_rank_split():
    """The loader's rank split (``EpochBatchSampler`` with a rank) takes
    the rows ``shard_rows`` takes of each global batch."""
    from gga_tpu_torch.data.dataset import EpochBatchSampler

    whole = list(EpochBatchSampler(23, 8, seed=3))
    for world in (1, 2, 4):
        for r in range(world):
            s = EpochBatchSampler(23, 8, seed=3, rank=r, world=world)
            assert list(s) == [mesh.shard_rows(np.asarray(b), r, world)
                               .tolist() for b in whole]
    with pytest.raises(ValueError, match='split'):
        EpochBatchSampler(23, 6, rank=0, world=4)


# --- the stage-2 CLI at two ranks ---------------------------------------------

def _cli_rank(rank, argv, out):
    """One rank of a torchrun-like launch of the stage-2 CLI: the
    environment torchrun sets, the rendezvous by ``--dist-url``."""
    from gga_tpu_torch.tools import train

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE='2')
    torch.save(train.main(argv), os.path.join(out, f'summary_{rank}.pt'))


def test_train_cli_two_ranks_rank_0_writes(tmp_path):
    """``tools/train.py`` as two ranks: the global batch is
    samples_per_gpu x 2, rank 0 alone writes the config dump, one log
    line a step and the checkpoint, in the one-process format: the
    one-process CLI resumes from it."""
    import json

    from gga_tpu_torch.tools import train

    from .test_torch_ddp_train import TINY, _mini_kitti

    kitti = str(tmp_path / 'kitti')
    _mini_kitti(kitti)
    work = str(tmp_path / 'work')
    argv = [TINY, '--work-dir', work, '--device', 'cpu', '--no-eval',
            '--cfg-options', f'data_root={kitti}/', 'loader_workers=0',
            'log_interval=1']
    torch.multiprocessing.spawn(
        _cli_rank, args=(argv + ['--max-steps', '2', '--dist-url',
                                 f'file://{tmp_path}/store'], str(tmp_path)),
        nprocs=2, join=True)
    lead, other = (torch.load(tmp_path / f'summary_{r}.pt') for r in (0, 1))
    assert lead['steps'] == other['steps'] == 2
    assert lead['ckpt_bytes'] > 0 and other['ckpt_bytes'] is None
    with open(os.path.join(work, 'train_log.jsonl')) as f:
        assert [json.loads(ln)['step'] for ln in f] == [1, 2]
    assert sorted(os.listdir(os.path.join(work, 'checkpoints'))) == [
        'step_2.pt']
    assert os.path.isfile(os.path.join(work, 'config_dump.py'))
    resumed = train.main(argv + ['--max-steps', '3', '--resume'])
    assert (resumed['start_step'], resumed['end_step']) == (2, 3)
    assert not torch.distributed.is_initialized()
