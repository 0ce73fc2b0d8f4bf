"""Data parallelism across processes on ``torch.distributed`` (the port's
counterpart of ``gga_tpu/parallel/mesh.py``).

gga_tpu runs one process per host over a ``Mesh(('data',))``: the batch
is sharded on axis 0, the parameters are replicated, and GSPMD makes
every reduction over the batch axis global (the batch-norm moments, the
loss normalisers) and sums the gradients, which subsumes the reference's
NaiveSyncBatchNorm and NCCL DDP. The port runs one process per card
(PyTorch's idiom): each rank takes its rows of the global batch
(``shard_rows``), the norms and losses pass their batch-axis sums
through ``global_sum``, and the train steps sum the gradients over ranks
with ``all_reduce_grads`` between the backward and the clip. N ranks on
the shards of a global batch then compute the loss, gradients and
batch-norm statistics that one process computes on the whole batch.

With no process group up (one process) every function here is the
identity or a no-op, so the callers keep their one-process arithmetic
bit for bit. Nothing here falls back: an unavailable backend or a failed
rendezvous raises.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

# the backends by name, each with its availability check
_BACKENDS = dict(nccl=dist.is_nccl_available, gloo=dist.is_gloo_available)


def world_size() -> int:
    """Ranks in the process group; 1 when no group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the group; 0 when no group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def distributed() -> bool:
    """True when a group of more than one rank is up."""
    return world_size() > 1


def process_shard(order, num_processes, process_id):
    """Deterministic per-process slice of a global sample order (the
    reference's DistributedGroupSampler rank split, torch
    DistributedSampler semantics): pad to a multiple of ``num_processes``
    by wrapping, then stride so every process sees a disjoint,
    equally-sized shard. Same ``order`` in => same shards out on every
    host."""
    order = np.asarray(order)
    n = len(order)
    total = -(-n // num_processes) * num_processes
    padded = np.concatenate([order, order[:total - n]])
    return padded[process_id::num_processes]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, backend=None):
    """Join a process group of ``num_processes`` ranks as ``process_id``
    (the reference's init_dist). A no-op returning False for one process;
    otherwise ``init_process_group`` and True.

    ``coordinator_address`` is the rendezvous: ``tcp://host:port``,
    ``file:///path`` (a FileStore, which needs no port) or None for
    ``env://`` (torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``).
    ``backend`` must be named: ``nccl`` where each rank has a card of its
    own, ``gloo`` on the CPU or for ranks that share a card. A backend
    this build of torch lacks raises; none is chosen in its place."""
    if num_processes is None or num_processes <= 1:
        return False
    if backend not in _BACKENDS:
        raise ValueError(f'backend must be one of {sorted(_BACKENDS)}, got '
                         f'{backend!r}')
    if not _BACKENDS[backend]():
        raise RuntimeError(f'the {backend} backend is not available in this '
                           'build of torch')
    dist.init_process_group(backend, init_method=coordinator_address
                            or 'env://', world_size=num_processes,
                            rank=process_id)
    return True


def init_from_env(device='cuda', url=None):
    """A command-line tool's launch: under ``torchrun`` (``WORLD_SIZE`` >
    1 in the environment) join the group as ``RANK`` on
    ``cuda:LOCAL_RANK`` (for ``device`` 'cuda'), over ``nccl`` on a card
    and ``gloo`` on the CPU, at ``url`` (by default ``env://``). Returns
    (device string, rank, world); one process gives (device, 0, 1) and
    joins nothing."""
    world = int(os.environ.get('WORLD_SIZE', '1'))
    if world <= 1:
        return device, 0, 1
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        device = f'cuda:{int(os.environ.get("LOCAL_RANK", "0"))}'
    if torch.device(device).type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(f'device {device!r} requested but no CUDA '
                               'device is available')
        torch.cuda.set_device(torch.device(device))
    init_distributed(url, world, int(os.environ['RANK']),
                     'nccl' if dev.type == 'cuda' else 'gloo')
    return device, rank(), world


def shutdown():
    """Leave the group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def barrier():
    """Wait for every rank; a no-op with no group."""
    if dist.is_initialized():
        dist.barrier()


def shard_rows(batch, rank, world):
    """Rank ``rank``'s rows of a global batch (a dict of arrays or
    tensors, or one of them): rows ``r*b ... (r+1)*b`` of axis 0 with
    ``b = B // world``, as ``P('data')`` splits axis 0 over the mesh.
    Axis 0 must divide by ``world``."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, rank, world) for k, v in batch.items()}
    n = batch.shape[0]
    if n % world:
        raise ValueError(f'a batch of {n} rows does not split over {world} '
                         'ranks')
    b = n // world
    return batch[rank * b:(rank + 1) * b]


def _all_reduce(t):
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


class _GlobalSum(torch.autograd.Function):
    """Sum over ranks whose gradient is the sum over ranks of the
    upstream gradients: each rank's loss is its share of the global loss,
    so d(sum of the ranks' losses)/d(a rank's term) is the sum of every
    rank's gradient at the reduced value."""

    @staticmethod
    def forward(ctx, t):
        return _all_reduce(t)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


def global_sum(t):
    """``t`` summed over the ranks (the same value on every rank), with a
    gradient that flows back to each rank's ``t``; ``t`` itself when no
    group of more than one rank is up."""
    if not distributed():
        return t
    if t.requires_grad:
        return _GlobalSum.apply(t)
    return _all_reduce(t)


def global_mean(t):
    """The mean of ``t``'s axis 0 over the global batch: ``t.mean()`` in
    one process; with ranks, this rank's sum over the global count (the
    ranks' values sum to the global mean)."""
    if not distributed():
        return t.mean()
    return t.sum() / (t.shape[0] * world_size())


def all_reduce_grads(params):
    """Sum the gradients of ``params`` over the ranks, in one all-reduce
    of a flat f32 buffer. A parameter without a gradient on this rank
    contributes zeros; one without a gradient on every rank keeps none,
    as in one process (the optimizer then skips it). A no-op with no
    group."""
    if not distributed():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    dev = params[0].device
    flat = torch.cat(
        [torch.tensor([p.grad is not None for p in params],
                      dtype=torch.float32, device=dev)]
        + [(p.grad if p.grad is not None else torch.zeros_like(p))
           .reshape(-1).float() for p in params])
    dist.all_reduce(flat)
    has = (flat[:len(params)] > 0).tolist()
    off = len(params)
    for p, h in zip(params, has):
        n = p.numel()
        if h:
            p.grad = flat[off:off + n].view_as(p).to(p.dtype)
        off += n


def sum_over_ranks(values):
    """A list of 0-d tensors, each summed over the ranks in one
    all-reduce; the list itself with no group."""
    if not distributed() or not values:
        return values
    flat = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(flat)
    return list(flat.unbind())
