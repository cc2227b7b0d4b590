from .rgcn_aggregate import (block_align_edges, block_align_edges_transposed,
                             block_align_plans, plan_capacity_blocks,
                             rgcn_aggregate, rgcn_aggregate_bwd,
                             rgcn_aggregate_bwd_ref, rgcn_aggregate_ref)

__all__ = ["block_align_edges", "block_align_edges_transposed",
           "block_align_plans", "plan_capacity_blocks", "rgcn_aggregate",
           "rgcn_aggregate_bwd", "rgcn_aggregate_bwd_ref", "rgcn_aggregate_ref"]
