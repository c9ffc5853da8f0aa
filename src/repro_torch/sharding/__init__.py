"""Sharded serving on a ``torch.distributed`` DeviceMesh: the serve mesh
(``ServeMesh``, per-shard block tables) and the logical-axis rules it reads
(``MeshRules``)."""
from .serve import (
    DECODE_WEIGHT_AXES,
    MESH_AXES,
    ROW_SHARDED_WEIGHTS,
    ServeMesh,
    gather_shards,
    parse_mesh_spec,
    shard_block_tables,
    validate_serve_mesh,
)
from .specs import (
    MeshRules,
    current_rules,
    logical_to_spec,
    set_rules,
    shard_act,
    use_rules,
)
