from .igmc import IGMC, IGMCConfig
from .rgcn import RGCNConv

__all__ = ["IGMC", "IGMCConfig", "RGCNConv"]
