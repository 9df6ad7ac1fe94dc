from ccd_tpu_torch.parallel.mesh import (all_gather_bytes, all_reduce_flat, all_reduce_max,
                                         all_reduce_sum, backend, barrier, broadcast_module,
                                         collective_counts, data_mesh, default_group,
                                         distributed_run,
                                         init_distributed, pretrain_mesh, rank, rank_seed,
                                         reset_collective_counts, shard_batch,
                                         shard_stacked_batch, world)

__all__ = ["init_distributed", "backend", "distributed_run", "default_group", "world", "rank", "rank_seed", "data_mesh",
           "pretrain_mesh", "all_reduce_sum", "all_reduce_max", "all_reduce_flat",
           "broadcast_module", "all_gather_bytes", "barrier", "shard_batch",
           "shard_stacked_batch", "collective_counts", "reset_collective_counts"]
