from .batch import (FLAT_ENGINES, GraphBatch, bucket_for, collate, flat_engine,
                    pad_ladder, planned_engine, topk_sum_bound)
from .dataset import BatchLoader, DynamicGraphDataset, StaticGraphDataset
from .dense import (DenseBatch, DenseBucket, collate_dense, plan_bipartite_buckets,
                    plan_dense_buckets, plan_rel_caps, slot_perm)
from .device_data import (DeviceDataset, assemble_batch, assemble_dense,
                          capacity_bound, live_rows, plan_gid_epoch)

__all__ = ["BatchLoader", "DenseBatch", "DenseBucket", "DeviceDataset",
           "DynamicGraphDataset", "FLAT_ENGINES",
           "GraphBatch", "StaticGraphDataset", "assemble_batch", "assemble_dense",
           "bucket_for", "capacity_bound", "collate", "collate_dense", "flat_engine",
           "live_rows",
           "pad_ladder", "plan_gid_epoch", "planned_engine",
           "plan_bipartite_buckets", "plan_dense_buckets", "plan_rel_caps", "slot_perm",
           "topk_sum_bound"]
