from .igmc import (IGMC, IGMCConfig, arr_regularizer, chunk_dense_batch,
                   draw_noise, igmc_forward_dense_chunked)
from .rgcn import (DensePlan, RGCNConv, build_dense_adj, dense_adj_degrees,
                   dense_plan, rgcn_dense_adj_apply, rgcn_dense_apply,
                   rgcn_dense_bipartite_apply, rgcn_dense_layer,
                   rgcn_dense_relslot_apply)

__all__ = ["DensePlan", "IGMC", "IGMCConfig", "RGCNConv", "arr_regularizer",
           "build_dense_adj", "chunk_dense_batch", "dense_adj_degrees",
           "dense_plan", "draw_noise", "igmc_forward_dense_chunked",
           "rgcn_dense_adj_apply", "rgcn_dense_apply",
           "rgcn_dense_bipartite_apply", "rgcn_dense_layer",
           "rgcn_dense_relslot_apply"]
