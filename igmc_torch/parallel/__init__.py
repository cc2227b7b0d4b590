"""Several devices over torch.distributed, one process per device: data
parallelism (dp.py), multi-host feeding (multihost.py) and edge-partitioned
giant batches (ep.py), on the process groups of mesh.py."""

from .dp import (make_dp_eval_step, make_dp_scan_train_step, make_dp_train_step,
                 rank_columns, rank_noise, split_for_devices, summed_gradient_step)
from .ep import (EPBatch, EPBlocked, EPCaps, EPShard, build_ep_batches,
                 build_ep_blocked, comm_stats, dropout_key_ids, ep_batch_caps,
                 ep_blocked_blocks, ep_eval_sums, ep_forward, ep_predict_all,
                 ep_shard, ep_step_seed, ep_train_epoch, halo_exchange,
                 make_ep_eval_step, make_ep_train_step,
                 max_ep_blocked_blocks, max_ep_caps, pad_ep_batch, pad_ep_blocked,
                 partition_batch)
from .mesh import Mesh, backend_for, init_group, make_mesh, spawn
from .multihost import (Subset, capacity_ladders, dynamic_capacity_ladders,
                        process_shard_indices)

__all__ = [
    "Mesh", "backend_for", "init_group", "make_mesh", "spawn",
    "make_dp_train_step", "make_dp_scan_train_step", "make_dp_eval_step",
    "rank_columns", "rank_noise", "split_for_devices", "summed_gradient_step",
    "EPBatch", "EPBlocked", "EPCaps", "EPShard", "build_ep_batches",
    "build_ep_blocked", "comm_stats", "dropout_key_ids", "ep_batch_caps",
    "ep_blocked_blocks", "ep_eval_sums", "ep_forward", "ep_predict_all",
    "ep_shard", "ep_step_seed", "ep_train_epoch", "halo_exchange",
    "make_ep_eval_step", "make_ep_train_step",
    "max_ep_blocked_blocks", "max_ep_caps", "pad_ep_batch", "pad_ep_blocked",
    "partition_batch",
    "Subset", "capacity_ladders", "dynamic_capacity_ladders",
    "process_shard_indices",
]
