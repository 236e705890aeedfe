"""Joining the processes of a multi-GPU job, and feeding each its batch.

Parity: easyanimate_tpu/parallel/multihost.py:25-65. Where JAX joins one
process per host through jax.distributed, the port runs one process per
GPU (torchrun or any launcher) joined by torch.distributed:

    torchrun --nproc_per_node 8 -m easyanimate_tpu_torch.train \\
        --distributed --mesh dp=2,sp=4 ...

or explicitly, per process:

    python -m easyanimate_tpu_torch.train --distributed \\
        --coordinator_address host0:29500 --num_processes N --process_id i

Explicit SPMD has no global array: a rank holds the rows of the global
batch that its dp index owns (the bucket sampler hands each dp rank its
own batches) and the sp peers of one dp index hold the same rows. So
local_batch_size, make_global_batch and sharding.data_spec are parity
stubs of the JAX package's API: the training driver calls none of them
and moves each batch to its device as it is.
"""
import datetime
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh

# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 600


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """init_process_group from explicit values or the launcher's
    environment (torchrun's MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK,
    LOCAL_RANK). `coordinator_address` is host:port (a TCP store) or a
    URL such as file:///path. On the card (device None or "cuda") the
    backend is NCCL and the process binds cuda:LOCAL_RANK (else
    process_id modulo the visible cards); device="cpu" takes gloo.
    Returns the device this process runs on."""
    kind = resolve_device(device).type
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if kind == "cpu":
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank, timeout=timeout)
        return torch.device("cpu")
    if kind != "cuda":
        raise ValueError(f"init_distributed runs on the card or the CPU, "
                         f"not {kind!r}")
    local = int(os.environ.get("LOCAL_RANK",
                               rank % max(torch.cuda.device_count(), 1)))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout,
                            device_id=dev)
    return dev


def local_batch_size(global_batch: int, mesh: Optional[Mesh] = None) -> int:
    """This rank's share of a global batch: global / dp (the sp peers of
    a dp index share its rows). A parity stub of the JAX package's API."""
    n = 1 if mesh is None else mesh.shape["dp"]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not divide over "
                         f"dp={n}")
    return global_batch // n


def dp_slice(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous share of a global tensor along `dim` (the
    batch), by its dp index."""
    n = mesh.shape["dp"]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over dp={n}")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.rank("dp") * size, size)


def make_global_batch(mesh: Mesh, batch: Dict, specs: Dict,
                      device: torch.device) -> Dict:
    """This rank's part of the global batch, as data_spec lays it out:
    `batch` holds the rows this process loaded (its dp share, as JAX's
    make_array_from_process_local_data takes them); a key whose spec puts
    'dp' on dim 0 must hold exactly those rows, the rest (and every 'sp'
    axis: the port shards tokens inside the model, not the latents) are the
    same on every rank. Tensors and arrays go to `device`.

    A parity stub of the JAX package's API: explicit SPMD has no global
    array to build, so this only moves the rows to `device` and checks
    that a dp-sharded entry has a batch dim."""
    out = {}
    for k, v in batch.items():
        spec = specs.get(k, ())
        t = torch.as_tensor(v) if not torch.is_tensor(v) else v
        if len(spec) and spec[0] == "dp" and t.dim() == 0:
            raise ValueError(f"{k}: a dp-sharded entry needs a batch dim")
        out[k] = t.to(device)
    return out
