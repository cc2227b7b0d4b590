from .igmc import IGMC, IGMCConfig, arr_regularizer, draw_noise
from .rgcn import RGCNConv

__all__ = ["IGMC", "IGMCConfig", "RGCNConv", "arr_regularizer", "draw_noise"]
