from ccd_tpu_torch.parallel.mesh import (Layout, all_gather_bytes, all_reduce_flat,
                                         all_reduce_max, all_reduce_sum, backend, barrier,
                                         broadcast_module, collective_counts,
                                         collective_counts_by_group, copy_to_model_group,
                                         data_mesh, default_group, distributed_run,
                                         gather_rows, init_distributed, pretrain_mesh, rank,
                                         rank_seed, reset_collective_counts, shard_batch,
                                         shard_rows, shard_stacked_batch, world)

__all__ = ["init_distributed", "backend", "distributed_run", "default_group", "world", "rank",
           "rank_seed", "data_mesh", "pretrain_mesh", "Layout",
           "all_reduce_sum", "all_reduce_max", "all_reduce_flat", "broadcast_module",
           "all_gather_bytes", "copy_to_model_group", "shard_rows", "gather_rows", "barrier",
           "shard_batch", "shard_stacked_batch", "collective_counts",
           "collective_counts_by_group", "reset_collective_counts"]
