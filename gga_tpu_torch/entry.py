"""The port's top-level entry points: a forward check and a
multi-process dry run (the counterparts of gga_tpu's
``__graft_entry__.py``).

- ``entry()``: a forward of the flagship model (the GGA weak detector,
  tiny config, seeded weights, eval mode) and its example arguments.
- ``dryrun_multichip(n)``: the FULL GGA training step (forward, targets,
  losses, backward, the gradients summed over the ranks, clip and AdamW)
  over ``n`` data-parallel processes, one scene a rank, at the dry run's
  reduced grid: ``gloo`` ranks on the CPU with ``device='cpu'``, else
  ``nccl`` ranks, one a card.

    python -m gga_tpu_torch.entry [--device cuda|cpu] [-n N]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch


def _example_inputs(B=1, P=2048, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.concatenate([
        rng.uniform(0, 70, (B, P, 1)), rng.uniform(-40, 40, (B, P, 1)),
        rng.uniform(-3, 1, (B, P, 1)), rng.rand(B, P, 1)],
        axis=-1).astype(np.float32)
    valid = np.ones((B, P), bool)
    return pts, valid


def _example_gga_targets(B, M, seed=1):
    rng = np.random.RandomState(seed)
    labels = np.full((B, M), -1, np.int32)
    labels[:, :6] = rng.randint(0, 3, (B, 6))
    obj_valid = np.zeros((B, M), bool)
    obj_valid[:, :6] = True
    pseudo = np.zeros((B, M, 7), np.float32)
    pseudo[:, :6, 0] = rng.uniform(5, 60, (B, 6))
    pseudo[:, :6, 1] = rng.uniform(-30, 30, (B, 6))
    pseudo[:, :6, 3:6] = rng.uniform(6, 14, (B, 6, 3))
    boxes_img = np.zeros((B, M, 4), np.float32)
    boxes_img[:, :6] = [200, 100, 800, 350]
    bdry = np.zeros((B, M, 4), bool)
    l2i = np.broadcast_to(np.eye(4, dtype=np.float32),
                          (B, M, 4, 4)).copy()
    l2i[..., 0, 0] = 700
    l2i[..., 1, 1] = 700
    l2i[..., 0, 2] = 600
    l2i[..., 1, 2] = 180
    ibp = rng.uniform(10, 50, (B, M, 32, 2)).astype(np.float32)
    ibp_valid = np.zeros((B, M, 32), bool)
    ibp_valid[:, :6, :8] = True
    return dict(labels=labels, obj_valid=obj_valid, init_pseudo=pseudo,
                boxes_img=boxes_img, bdry_masks=bdry, lidar2img=l2i,
                ibp_xy=ibp, ibp_valid=ibp_valid)


def entry(device='cuda'):
    """Returns (fn, example_args): the tiny GGA detector's forward in eval
    mode, giving each task's heatmap, reg, height, dim and rot maps."""
    from . import apis
    from .models.detectors.centerpoint_gga import GGAModelConfig

    bundle = apis.init_detector(GGAModelConfig.tiny(), device=device,
                                seed=0)
    pts, valid = _example_inputs()
    args = (torch.from_numpy(pts).to(bundle.device),
            torch.from_numpy(valid).to(bundle.device))

    @torch.no_grad()
    def fn(points, points_valid):
        preds = bundle.model(points, points_valid)
        return tuple(p[k] for p in preds
                     for k in ('heatmap', 'reg', 'height', 'dim', 'rot'))

    return fn, args


def _dryrun_config():
    """The FULL GGA architecture (default channel widths and depths,
    max_objs=500 target assignment) on gga_tpu's ``tiny`` dry-run grid:
    0.2 m voxels, 4096-voxel budgets."""
    from .models.dense_heads.centerpoint_head_gga import GGAHeadConfig
    from .models.detectors.centerpoint_gga import GGAModelConfig

    return dataclasses.replace(
        GGAModelConfig(),
        voxel_size=(0.2, 0.2, 0.1),
        max_voxels=4096, sparse_shape=(41, 400, 352),
        encoder_budgets=(4096, 4096, 3072), encoder_out_budget=3072,
        head=GGAHeadConfig(grid_size=(352, 400, 40),
                           voxel_size=(0.2, 0.2, 0.1)))


def _dryrun_rank(rank, n, device, url, out):
    """One rank of ``dryrun_multichip``: join the group, take this rank's
    scene of the global batch, one train step; the weights after it must
    equal rank 0's bit for bit."""
    from . import apis
    from .parallel import mesh

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if device == 'cuda':
        device = f'cuda:{rank}'
        torch.cuda.set_device(rank)
    mesh.init_distributed(url, n, rank,
                          'gloo' if device == 'cpu' else 'nccl')
    try:
        cfg = _dryrun_config()
        trainer = apis.init_trainer(cfg, total_steps=100, device=device,
                                    seed=0)
        pts, valid = _example_inputs(B=n, P=1024)
        batch = dict(points=pts, points_valid=valid,
                     **_example_gga_targets(n, cfg.head.max_objs))
        logs = apis.train_step(trainer, mesh.shard_rows(batch, rank, n))
        loss = float(logs['loss'])
        if not np.isfinite(loss) or trainer.step != 1:
            raise RuntimeError(f'rank {rank}: loss {loss}, step '
                               f'{trainer.step}')
        flat = torch.cat([p.detach().reshape(-1)
                          for p in trainer.model.parameters()])
        lead = flat.clone()
        torch.distributed.broadcast(lead, 0)
        if not torch.equal(flat, lead):
            raise RuntimeError(f'rank {rank}: weights differ from rank 0 '
                               'after the step')
        if rank == 0:
            torch.save(dict(loss=loss, grad_norm=float(logs['grad_norm'])),
                       out)
    finally:
        mesh.shutdown()


def dryrun_multichip(n_devices: int, device='cuda') -> dict:
    """The full train step over ``n_devices`` data-parallel processes,
    one real step; returns rank 0's loss and grad norm. Each rank is a
    process started with ``spawn``; a rank's failure raises here."""
    if device == 'cuda' and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f'need {n_devices} CUDA devices, have '
                           f'{torch.cuda.device_count()}')
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'rank0.pt')
        torch.multiprocessing.spawn(
            _dryrun_rank, args=(n_devices, device,
                                f'file://{os.path.join(tmp, "store")}', out),
            nprocs=n_devices, join=True)
        res = torch.load(out)
    print(f'dryrun_multichip({n_devices}) ok: loss={res["loss"]:.4f}, '
          f'grad_norm={res["grad_norm"]:.4f}')
    return res


if __name__ == '__main__':
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--device', default='cuda')
    ap.add_argument('-n', type=int, default=2)
    a = ap.parse_args()
    fn, example = entry(a.device)
    print('entry forward ok:', [tuple(o.shape) for o in fn(*example)[:5]])
    dryrun_multichip(a.n, a.device)
