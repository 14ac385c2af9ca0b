"""The paper's primary contribution: DDS graph + Lambda Neural Network."""
from repro_torch.core.dds import (
    DDSGraph,
    IncrementalDDSBuilder,
    StaticGraph,
    build_dds,
    check_no_future_leak,
)
from repro_torch.core.graph import COOGraph, EdgeType, NodeType, PaddedGraph, pad_graph
from repro_torch.core.hetero import (
    ENTITY_TYPE_NAMES,
    entity_type_of,
    is_typed,
    strip_type,
    tag_entity,
    type_code_of,
)
from repro_torch.core.lnn import (
    LNNConfig,
    lnn_forward,
    lnn_init,
    lnn_loss,
    lnn_order_tower,
    lnn_stage1,
    lnn_stage2_batch,
    lnn_stage2_embed,
    lnn_stage2_online,
)
from repro_torch.core.partition import partition_transactions

__all__ = [
    "COOGraph",
    "EdgeType",
    "NodeType",
    "PaddedGraph",
    "pad_graph",
    "DDSGraph",
    "IncrementalDDSBuilder",
    "StaticGraph",
    "build_dds",
    "check_no_future_leak",
    "ENTITY_TYPE_NAMES",
    "entity_type_of",
    "is_typed",
    "strip_type",
    "tag_entity",
    "type_code_of",
    "LNNConfig",
    "lnn_forward",
    "lnn_init",
    "lnn_loss",
    "lnn_order_tower",
    "lnn_stage1",
    "lnn_stage2_batch",
    "lnn_stage2_embed",
    "lnn_stage2_online",
    "partition_transactions",
]
