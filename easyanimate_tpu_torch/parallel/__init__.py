"""Multi-GPU execution on torch.distributed: the mesh (dp, sp; tp not
ported), joining the processes, sequence-parallel attention (ring,
all-gather, Ulysses) and ZeRO-2 / FSDP for training. The port of
easyanimate_tpu/parallel/ (the same four modules)."""
from .context import (current_sp, gather_tokens, make_sp_attention,
                      sequence_parallel, sp_constraint)
from .mesh import Mesh, MeshConfig, create_mesh, parse_mesh
from .multihost import (dp_slice, init_distributed, local_batch_size,
                        make_global_batch)
from .sharding import ZeroShards, data_spec, fsdp_shard, zero_param_specs

__all__ = [
    "Mesh",
    "MeshConfig",
    "ZeroShards",
    "create_mesh",
    "current_sp",
    "data_spec",
    "dp_slice",
    "fsdp_shard",
    "gather_tokens",
    "init_distributed",
    "local_batch_size",
    "make_global_batch",
    "make_sp_attention",
    "parse_mesh",
    "sequence_parallel",
    "sp_constraint",
    "zero_param_specs",
]
