from .batch import GraphBatch, bucket_for, collate, pad_ladder, topk_sum_bound
from .dataset import BatchLoader, DynamicGraphDataset, StaticGraphDataset
from .dense import (DenseBatch, DenseBucket, collate_dense, plan_bipartite_buckets,
                    plan_dense_buckets, plan_rel_caps, slot_perm)
from .device_data import DeviceDataset, assemble_dense, live_rows

__all__ = ["BatchLoader", "DenseBatch", "DenseBucket", "DeviceDataset",
           "DynamicGraphDataset",
           "GraphBatch", "StaticGraphDataset", "assemble_dense", "bucket_for",
           "collate", "collate_dense", "live_rows", "pad_ladder",
           "plan_bipartite_buckets", "plan_dense_buckets", "plan_rel_caps", "slot_perm",
           "topk_sum_bound"]
