"""The device mesh over the processes of one torch.distributed job.

Parity: easyanimate_tpu/parallel/mesh.py:12-42. The axes are the JAX
package's:
  dp - data parallel (the batch)
  sp - sequence parallel (the video tokens of one sample)
  tp - tensor parallel (heads / FFN hidden): not ported, tp > 1 raises.
The port is explicit SPMD: one process per GPU, each holding its own shard
and communicating where attention and the optimizer need it. The ranks of
the mesh are laid out dp-major, sp, tp: rank = (dp_i * sp + sp_i) * tp +
tp_i, so the sp peers of one sample are neighbours.
"""
import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("dp", "sp", "tp")
NOT_PORTED = "is not ported (ROADMAP queue 1 item 10: multi-GPU)"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = -1   # -1: absorb the remaining ranks
    sp: int = 1
    tp: int = 1


class Mesh:
    """A ("dp", "sp", "tp") DeviceMesh and, for ZeRO-2 and FSDP, `data`:
    the same ranks flattened into one axis ("data", dp * sp ranks), over
    which optimizer state (and with FSDP the parameters) are sharded.
    `shape` maps each axis to its size, as a JAX Mesh's does."""

    def __init__(self, device_mesh: DeviceMesh, data: DeviceMesh):
        self.device_mesh = device_mesh
        self.data = data
        self.shape: Dict[str, int] = dict(zip(AXES, device_mesh.shape))
        self.axis_names = AXES

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def contains_rank(self) -> bool:
        """False on a rank outside a sub-mesh (that rank takes no part)."""
        return self.device_mesh.get_coordinate() is not None

    def group(self, axis: str):
        """The process group of this rank's peers along `axis` ("data" for
        the flattened dp x sp ranks)."""
        if axis == "data":
            return self.data.get_group()
        return self.device_mesh.get_group(axis)

    def rank(self, axis: str) -> int:
        if axis == "data":
            return self.data.get_local_rank()
        return self.device_mesh.get_local_rank(axis)

    def size(self, axis: str) -> int:
        if axis == "data":
            return self.shape["dp"] * self.shape["sp"]
        return self.shape[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type})"


def create_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The mesh over ranks [0, dp * sp * tp) of the default process group
    (init_distributed first). dp=-1 absorbs the remaining ranks; an
    explicit mesh smaller than the world runs on a sub-mesh, and the ranks
    outside it take no part (Mesh.contains_rank). tp > 1 raises."""
    if cfg.tp != 1:
        raise NotImplementedError(f"tensor parallelism (tp={cfg.tp}) "
                                  f"{NOT_PORTED}")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.init_distributed first")
    n = dist.get_world_size()
    dp = cfg.dp
    if dp == -1:
        if n % (cfg.sp * cfg.tp):
            raise ValueError(f"{n} ranks do not divide into sp={cfg.sp} x "
                             f"tp={cfg.tp}")
        dp = n // (cfg.sp * cfg.tp)
    need = dp * cfg.sp * cfg.tp
    if not 0 < need <= n:
        raise ValueError(f"mesh dp={dp} sp={cfg.sp} tp={cfg.tp} needs {need} "
                         f"ranks; the job has {n}")
    device_type = ("cuda" if dist.get_backend() == dist.Backend.NCCL
                   else "cpu")
    ranks = torch.arange(need)
    return Mesh(DeviceMesh(device_type, ranks.reshape(dp, cfg.sp, cfg.tp),
                           mesh_dim_names=AXES),
                DeviceMesh(device_type, ranks, mesh_dim_names=("data",)))


def parse_mesh(spec: str) -> MeshConfig:
    """'dp=2,sp=4,tp=1' (any subset of the axes) -> MeshConfig."""
    kw = {}
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        if k not in AXES or not v:
            raise ValueError(f"mesh spec {spec!r}: expected dp=..,sp=..,tp=..")
        kw[k] = int(v)
    return MeshConfig(**kw)
