from .batch import GraphBatch, bucket_for, collate, pad_ladder, topk_sum_bound
from .dataset import BatchLoader, StaticGraphDataset
from .dense import (DenseBatch, DenseBucket, collate_dense, plan_bipartite_buckets,
                    plan_dense_buckets, slot_perm)
from .device_data import DeviceDataset, assemble_dense, live_rows

__all__ = ["BatchLoader", "DenseBatch", "DenseBucket", "DeviceDataset",
           "GraphBatch", "StaticGraphDataset", "assemble_dense", "bucket_for",
           "collate", "collate_dense", "live_rows", "pad_ladder",
           "plan_bipartite_buckets", "plan_dense_buckets", "slot_perm",
           "topk_sum_bound"]
