from .igmc import IGMC, IGMCConfig, arr_regularizer, draw_noise
from .rgcn import (DensePlan, RGCNConv, dense_plan, rgcn_dense_apply,
                   rgcn_dense_bipartite_apply, rgcn_dense_layer)

__all__ = ["DensePlan", "IGMC", "IGMCConfig", "RGCNConv", "arr_regularizer",
           "dense_plan", "draw_noise", "rgcn_dense_apply",
           "rgcn_dense_bipartite_apply", "rgcn_dense_layer"]
