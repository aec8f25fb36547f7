"""The training drivers of the port on one device or a mesh of ranks
(the JAX package's `parallel/`): the mesh over torch.distributed, the
sharding rules, the layer -> function bridge, `SpmdTrainer` with data,
tensor and expert parallelism, ring attention over `sp` and the GPipe
schedule over `pp`.

The JAX package drives every device from one process through
`shard_map`; the port runs one process a rank, and a rank's code
already runs on its shard (`mesh.py`). Axes (canonical order): dp
(data), fsdp (weight storage, serving), pp (pipeline stage), tp (tensor
/ Megatron), sp (sequence, for ring attention), ep (experts).
"""
from .functional import FunctionalModule, functionalize
from .mesh import DeviceMesh, auto_mesh, get_mesh, init_mesh, mesh_axis_size
from .pipeline import pipeline_spmd_fn, stack_stage_params
from .ring import ring_attention, zigzag_permutation
from .sharding import (COMMON_TP_RULES, ShardingRules, batch_sharding,
                       fitted_sharding, gather_tensor, infer_param_specs,
                       named_sharding, serving_param_rules, shard_tensor)
from .spmd import SpmdTrainer, spmd_data_parallel

__all__ = ["DeviceMesh", "init_mesh", "auto_mesh", "get_mesh",
           "mesh_axis_size", "ShardingRules", "COMMON_TP_RULES",
           "serving_param_rules", "infer_param_specs", "named_sharding",
           "fitted_sharding", "batch_sharding", "shard_tensor",
           "gather_tensor", "functionalize", "FunctionalModule",
           "SpmdTrainer", "spmd_data_parallel", "ring_attention",
           "zigzag_permutation", "pipeline_spmd_fn", "stack_stage_params"]
