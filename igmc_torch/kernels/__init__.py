from .rgcn_aggregate import (block_align_edges, plan_capacity_blocks,
                             rgcn_aggregate, rgcn_aggregate_ref)

__all__ = ["block_align_edges", "plan_capacity_blocks", "rgcn_aggregate",
           "rgcn_aggregate_ref"]
