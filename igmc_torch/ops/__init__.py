from .dropout import edge_dropout_dense, feature_dropout, hash_edge_keep
from .sort_pool import dense_sort_pool

__all__ = ["dense_sort_pool", "edge_dropout_dense", "feature_dropout",
           "hash_edge_keep"]
