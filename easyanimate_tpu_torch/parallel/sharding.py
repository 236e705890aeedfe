"""Where each tensor lives across the mesh: ZeRO-2 and FSDP for the
trainer's float32 masters, optimizer state and EMA, and the batch layout.

Parity: easyanimate_tpu/parallel/sharding.py:78-133. The reference trains
under DeepSpeed ZeRO stage 2 (config/zero_stage2_config.json): optimizer
state partitioned across the data-parallel ranks, the model's parameters
replicated. Here, on the `data` axis of the mesh (the dp x sp ranks):
  - ZeRO-2 (`--distributed`): each rank keeps a 1/(dp*sp) slice of every
    float32 master, Adam moment and EMA tensor, along its largest
    divisible dimension (zero_param_specs; a tensor with none stays whole
    on every rank). Gradients are reduce-scattered into that slice, the
    optimizer updates the slice, and the updated slices are all-gathered
    into the replicated parameters of the model.
  - FSDP (`--fsdp`): FSDP2's fully_shard also shards the model's
    parameters, per block, on dim 0 (fsdp_shard); its reduce-scatter
    leaves each rank its dim-0 chunk of every gradient, and the masters,
    moments and EMA follow those chunks.
Gradient reduction: the sp peers of a sample each hold the gradient of
the paths through their own tokens, so they sum; the dp ranks average.
Tensor parallelism (mmdit_param_specs' Megatron column / row linears) is
not ported: tp > 1 raises at create_mesh.
"""
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .context import all_gather_dim, reduce_scatter_dim
from .mesh import Mesh


def data_spec(kind: str) -> Tuple[Optional[str], ...]:
    """The port's batch layout, per dim: the batch on 'dp'; everything else
    is the same on every sp rank (JAX puts the latents' frames on 'sp';
    the port shards the video tokens after the patchify, inside the model,
    so the latents, text, timesteps and RoPE tables reach it whole). A
    parity stub of the JAX package's API: only make_global_batch reads
    it, and the training driver calls neither."""
    if kind in ("latents", "video"):
        return ("dp", None, None, None, None)
    if kind == "text":
        return ("dp", None, None)
    if kind == "timesteps":
        return ("dp",)
    raise ValueError(kind)


def zero_param_specs(params: Dict[str, torch.Tensor], mesh: Mesh,
                     zero_axes=("dp", "sp")) -> Dict[str, Optional[int]]:
    """ZeRO-2 layout of the optimizer state (and EMA): per parameter name,
    the dimension sharded over `zero_axes` -- the largest one that their
    product divides -- or None (the tensor stays whole on every rank)."""
    factor = int(np.prod([mesh.shape[a] for a in zero_axes]))
    out = {}
    for name, p in params.items():
        shape = tuple(p.shape)
        out[name] = None
        if factor > 1:
            for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
                if shape[i] % factor == 0:
                    out[name] = i
                    break
    return out


def fsdp_shard(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """FSDP2 over the mesh's data ranks: each transformer block one
    all-gather unit, the rest of the model the root's (JAX
    examples/train.py:404-409 shards the params over the data axes)."""
    from torch.distributed.fsdp import fully_shard

    for block in model.transformer_blocks:
        fully_shard(block, mesh=mesh.data)
    fully_shard(model, mesh=mesh.data)
    return model


def _chunk(n: int, parts: int, index: int) -> Tuple[int, int]:
    """(start, length) of chunk `index` of n rows in `parts` chunks of
    ceil(n / parts), the last ones shorter or empty (torch.chunk's and
    FSDP2's layout)."""
    c = -(-n // parts)
    start = min(index * c, n)
    return start, min(start + c, n) - start


def map_named(obj: Any, names, fn: Callable[[str, torch.Tensor], Any]) -> Any:
    """`obj` (a training state: dataclasses, NamedTuples, tuples, lists,
    dicts) with fn(name, tensor) applied to every tensor held in a dict
    under a parameter name of `names` (masters, moments, accumulators,
    EMA); everything else as it is."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_named(getattr(obj, f.name), names, fn)
            for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_named(v, names, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_named(v, names, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: fn(k, v) if k in names and torch.is_tensor(v)
                else map_named(v, names, fn) for k, v in obj.items()}
    return obj


class ZeroShards:
    """Where this rank keeps each parameter's float32 master, optimizer
    state and EMA: a chunk along dims[name] over the mesh's data ranks, or
    the whole tensor (dims[name] None). FSDP when the model's parameters
    are DTensors (fsdp_shard ran): every tensor's dim-0 chunk, FSDP2's
    own; ZeRO-2 otherwise: zero_param_specs."""

    def __init__(self, named: Dict[str, torch.Tensor], mesh: Mesh):
        from torch.distributed.tensor import DTensor

        self.mesh = mesh
        self.group = mesh.group("data")
        self.parts = mesh.size("data")
        self.index = mesh.rank("data")
        self.dp = mesh.shape["dp"]
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        self.fsdp = any(isinstance(p, DTensor) for p in named.values())
        self.dims = (dict.fromkeys(named, 0) if self.fsdp
                     else zero_param_specs(named, mesh))
        # FSDP2's reduce-scatter averages over all data ranks; the sp peers'
        # gradients must sum, so the loss is scaled by sp before backward
        self.loss_scale = float(mesh.shape["sp"]) if self.fsdp else 1.0

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's chunk of a whole tensor of parameter `name`."""
        dim = self.dims[name]
        if dim is None:
            return full
        start, n = _chunk(full.shape[dim], self.parts, self.index)
        return full.narrow(dim, start, n)

    @torch.no_grad()
    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's chunk (a collective)."""
        dim = self.dims[name]
        if dim is None:
            return local
        n = self.shapes[name][dim]
        c = -(-n // self.parts)
        if local.shape[dim] < c:
            pad = list(local.shape)
            pad[dim] = c - local.shape[dim]
            local = torch.cat([local, local.new_zeros(pad)], dim=dim)
        return all_gather_dim(local, dim, self.group).narrow(dim, 0, n)

    @torch.no_grad()
    def masters(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """float32 copies of this rank's chunks of the parameters."""
        if self.fsdp:
            return {n: p.to_local().float().clone() for n, p in named.items()}
        return {n: self.local(n, p.detach()).float().clone()
                for n, p in named.items()}

    @torch.no_grad()
    def grads(self, named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's chunks of the gradient, in float32: the sum over the
        sp peers, the mean over dp. FSDP2's backward already reduced them;
        under ZeRO-2 each is reduce-scattered (a whole tensor
        all-reduced)."""
        out = {}
        for n, p in named.items():
            if self.fsdp:
                g = p.grad
                out[n] = (torch.zeros(p.to_local().shape,
                                      device=p.to_local().device)
                          if g is None else g.to_local().float())
                continue
            g = (torch.zeros(p.shape, device=p.device) if p.grad is None
                 else p.grad.float())
            dim = self.dims[n]
            if dim is None:
                dist.all_reduce(g, group=self.group)
            else:
                g = reduce_scatter_dim(g, dim, self.group)
            out[n] = g.div_(self.dp) if self.dp > 1 else g
        return out

    def global_norm(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """optim.global_norm of the whole (unsharded) tree: the chunks'
        squares summed over the data ranks, whole tensors counted once."""
        sq = lambda names: sum((tree[n].float().square().sum() for n in names),
                               torch.zeros((), device=self._device(tree)))
        chunked = [n for n in tree if self.dims[n] is not None]
        total = sq(chunked)
        dist.all_reduce(total, group=self.group)
        return torch.sqrt(total + sq([n for n in tree if self.dims[n] is None]))

    @staticmethod
    def _device(tree):
        return next(iter(tree.values())).device

    @torch.no_grad()
    def write_params(self, named: Dict[str, torch.Tensor],
                     masters: Dict[str, torch.Tensor]) -> None:
        """The updated masters into the model's parameters: FSDP's local
        chunks in place; under ZeRO-2 the chunks all-gathered (in the
        parameter's dtype) into the replicated parameter."""
        for n, p in named.items():
            if self.fsdp:
                p.to_local().copy_(masters[n])
            else:
                p.copy_(self.full(n, masters[n].to(p.dtype)))

    def gather_state(self, state: Any) -> Any:
        """The training state with every chunk replaced by its whole
        tensor, on the host of the first data rank (a checkpoint's
        writer); the other ranks get None in its place. A collective:
        every rank calls it; one whole tensor at a time is on the card."""
        def whole(name, t):
            t = self.full(name, t)
            return t.cpu() if self.index == 0 else None

        return map_named(state, self.dims, whole)

    def shard_state(self, state: Any) -> Any:
        """A whole training state (a checkpoint) -> this rank's chunks,
        as views (of a memory-mapped file: only the chunks are read when
        they are copied)."""
        return map_named(state, self.dims, self.local)
