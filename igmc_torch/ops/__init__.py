from .dropout import edge_dropout_dense, feature_dropout, hash_edge_keep

__all__ = ["edge_dropout_dense", "feature_dropout", "hash_edge_keep"]
