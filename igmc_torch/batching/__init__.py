from .batch import GraphBatch, bucket_for, collate, pad_ladder, topk_sum_bound
from .dataset import BatchLoader, StaticGraphDataset

__all__ = ["BatchLoader", "GraphBatch", "StaticGraphDataset", "bucket_for",
           "collate", "pad_ladder", "topk_sum_bound"]
