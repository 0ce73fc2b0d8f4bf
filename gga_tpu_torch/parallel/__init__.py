"""Data parallelism across processes on ``torch.distributed`` and the
sharded stage-3 inference (the port's ``gga_tpu/parallel``)."""
from .dist_eval import (collect_parts, dump_part, run_sharded_inference,
                        shard_indices)
from .mesh import (all_reduce_grads, global_mean, global_sum,
                   init_distributed, process_shard, shard_rows)

__all__ = ['all_reduce_grads', 'collect_parts', 'dump_part', 'global_mean',
           'global_sum', 'init_distributed', 'process_shard',
           'run_sharded_inference', 'shard_indices', 'shard_rows']
