from .dropout import feature_dropout, hash_edge_keep

__all__ = ["feature_dropout", "hash_edge_keep"]
