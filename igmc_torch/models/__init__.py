from .families import (DGCNN, DGCNNConfig, GNN, GNNConfig,
                       sortpool_k_from_dataset)
from .igmc import (IGMC, IGMCConfig, arr_regularizer, chunk_dense_batch,
                   draw_noise, igmc_forward_dense_chunked, set_flat_engine)
from .rgcn import (DensePlan, GCNConv, GCNPlan, RGCNConv, build_dense_adj,
                   dense_adj_degrees, dense_plan, gcn_dense_apply, gcn_dense_layer,
                   gcn_dense_plan, rgcn_dense_adj_apply, rgcn_dense_apply,
                   rgcn_dense_bipartite_apply, rgcn_dense_layer,
                   rgcn_dense_relslot_apply)

__all__ = ["DGCNN", "DGCNNConfig", "DensePlan", "GCNConv", "GCNPlan", "GNN",
           "GNNConfig", "IGMC", "IGMCConfig", "RGCNConv", "arr_regularizer",
           "build_dense_adj", "chunk_dense_batch", "dense_adj_degrees",
           "dense_plan", "draw_noise", "gcn_dense_apply", "gcn_dense_layer",
           "gcn_dense_plan", "igmc_forward_dense_chunked",
           "rgcn_dense_adj_apply", "rgcn_dense_apply",
           "rgcn_dense_bipartite_apply", "rgcn_dense_layer",
           "rgcn_dense_relslot_apply", "set_flat_engine",
           "sortpool_k_from_dataset"]
