from .mesh import (comm_device, data_parallel, destroy_process_group, init_process_group,
                   is_distributed, is_main_process, local_batch_size, padded_shard,
                   rank, shard_items, world_size)
from .multihost import accumulate_results, all_gather_objects

__all__ = ["accumulate_results", "all_gather_objects", "comm_device", "data_parallel",
           "destroy_process_group", "init_process_group", "is_distributed",
           "is_main_process", "local_batch_size", "padded_shard", "rank",
           "shard_items", "world_size"]
