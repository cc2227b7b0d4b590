from .csr import BipartiteCSR
from .extract import Subgraph, extract_many, extract_subgraph

__all__ = ["BipartiteCSR", "Subgraph", "extract_many", "extract_subgraph"]
