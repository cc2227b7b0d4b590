from .blocked import (BlockedEdges, BlockedPlan, blocked_degree, blocked_rel_counts,
                      blocked_rgcn_aggregate, dropout_masks, plan_blocked_edges,
                      relmean_weights)
from .dropout import (edge_dropout, edge_dropout_dense, feature_dropout,
                      flat_edge_keep, hash_edge_keep)
from .segment import masked_segment_mean, masked_segment_sum, segment_sum
from .sort_pool import dense_sort_pool, global_sort_pool

__all__ = ["BlockedEdges", "BlockedPlan", "blocked_degree", "blocked_rel_counts",
           "blocked_rgcn_aggregate", "dropout_masks", "plan_blocked_edges",
           "relmean_weights", "dense_sort_pool", "edge_dropout", "edge_dropout_dense",
           "feature_dropout", "flat_edge_keep", "global_sort_pool",
           "hash_edge_keep", "masked_segment_mean", "masked_segment_sum",
           "segment_sum"]
