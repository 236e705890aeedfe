"""Checkpoint save / resume in safetensors.

Parity: easyanimate_tpu/training/checkpoints.py (reference train.py:
1119-1170, 2152-2176): periodic saves to `checkpoint-<step>/` with
rotation to a total limit, the sampler cursor in `sampler.json` for an
exact data-order resume, and latest-checkpoint discovery that falls back
to the previous checkpoint when the latest does not load (train.py:
1564-1626). Where JAX writes the state with orbax, the port writes it with
its own safetensors writer (utils/safetensors_io.py; the card's machine
has neither orbax nor safetensors):
  - `state.safetensors`: every tensor of the training state (float32
    masters or LoRA factors, optimizer state with its int8 blocks, EMA),
    named t0, t1, ... in tree order, each in its own dtype;
  - `state.json`: the tree's structure (TrainState, NamedTuples of dicts,
    tuples, ints and floats such as the step and optimizer counters), with
    each tensor's name, dtype and shape.
Both are read back bit-exactly.

Under a mesh (parallel/sharding.py, ZeRO-2 or FSDP) each rank holds chunks
of the masters, moments and EMA: a CheckpointManager given the ranks'
`shards` all-gathers them at `save` and the mesh's first data rank writes
the whole tensors, in the same layout (barriers around the write);
`restore_latest` reads the whole tensors and keeps this rank's chunks, so
a checkpoint restores at any rank count, one process included.
"""
import dataclasses
import importlib
import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.safetensors_io import DTYPES, load_file, save_file

_PACKAGE = __name__.split(".")[0]
_DTYPE_NAMES = {v: k for k, v in DTYPES.items()}


def _class_path(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}:{cls.__qualname__}"


def _class(path: str):
    module, name = path.split(":")
    if module.split(".")[0] != _PACKAGE:
        raise ValueError(f"checkpoint names a class outside {_PACKAGE}: {path}")
    return getattr(importlib.import_module(module), name)


def flatten_state(obj, tensors: List[torch.Tensor]):
    """The JSON spec of `obj`; its tensors appended to `tensors`."""
    if torch.is_tensor(obj):
        tensors.append(obj)
        return {"tensor": f"t{len(tensors) - 1}",
                "dtype": _DTYPE_NAMES[obj.dtype], "shape": list(obj.shape)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"value": obj}
    if dataclasses.is_dataclass(obj):
        return {"dataclass": _class_path(obj),
                "fields": {f.name: flatten_state(getattr(obj, f.name), tensors)
                           for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {"namedtuple": _class_path(obj),
                "fields": [flatten_state(v, tensors) for v in obj]}
    if isinstance(obj, (tuple, list)):
        return {type(obj).__name__: [flatten_state(v, tensors) for v in obj]}
    if isinstance(obj, dict):
        if not all(isinstance(k, str) for k in obj):
            raise TypeError("checkpointed dicts need string keys")
        return {"dict": [[k, flatten_state(v, tensors)] for k, v in obj.items()]}
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def unflatten_state(spec, tensors):
    """flatten_state's inverse; `tensors` maps tensor names to tensors."""
    if "tensor" in spec:
        return tensors[spec["tensor"]]
    if "value" in spec:
        return spec["value"]
    if "dataclass" in spec:
        return _class(spec["dataclass"])(**{
            k: unflatten_state(v, tensors) for k, v in spec["fields"].items()})
    if "namedtuple" in spec:
        return _class(spec["namedtuple"])(
            *[unflatten_state(v, tensors) for v in spec["fields"]])
    if "tuple" in spec:
        return tuple(unflatten_state(v, tensors) for v in spec["tuple"])
    if "list" in spec:
        return [unflatten_state(v, tensors) for v in spec["list"]]
    return {k: unflatten_state(v, tensors) for k, v in spec["dict"]}


def _structure(spec):
    """spec without its plain values (counters and steps differ between a
    template and a saved state of the same structure)."""
    if isinstance(spec, dict):
        return {k: None if k == "value" else _structure(v)
                for k, v in spec.items()}
    if isinstance(spec, list):
        return [_structure(v) for v in spec]
    return spec


def save_state(path: str, state: Any) -> None:
    """`state` as `path`/state.safetensors + `path`/state.json."""
    os.makedirs(path, exist_ok=True)
    tensors: List[torch.Tensor] = []
    spec = flatten_state(state, tensors)
    save_file({f"t{i}": t for i, t in enumerate(tensors)},
              os.path.join(path, "state.safetensors"))
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(spec, f)


def load_state(path: str, template: Any = None, device=None,
               shards=None) -> Any:
    """save_state's files -> the state. With a template, the structure,
    every dtype and shape must match it, and each tensor goes to its
    template tensor's device; without one, to `device` (the card by
    default). With `shards` (a ZeroShards) the template holds this rank's
    chunks, and only those are read from the whole tensors of the file."""
    with open(os.path.join(path, "state.json")) as f:
        spec = json.load(f)
    raw = load_file(os.path.join(path, "state.safetensors"))
    if shards is not None:
        if template is None:
            raise ValueError("a sharded restore needs the template state")
        # the rank's chunks of the file's whole tensors, renamed in order
        chunks: List[torch.Tensor] = []
        spec = flatten_state(shards.shard_state(unflatten_state(spec, raw)),
                             chunks)
        raw = {f"t{i}": t for i, t in enumerate(chunks)}
    if template is not None:
        like: List[torch.Tensor] = []
        if _structure(flatten_state(template, like)) != _structure(spec):
            raise ValueError(f"{path}: state does not match the template")
        devices = [t.device for t in like]
    else:
        devices = [resolve_device(device)] * len(raw)
    tensors = {}
    for i, dev in enumerate(devices):
        t = raw[f"t{i}"]
        # a host copy: the memory-mapped file must not stay the tensor
        tensors[f"t{i}"] = t.clone() if dev.type == "cpu" else t.to(dev)
    return unflatten_state(spec, tensors)


class CheckpointManager:
    """Checkpoints under `directory`; with `shards` (a ZeroShards) every
    rank of the mesh saves and restores its chunks (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 5, shards=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.shards = shards

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("checkpoint-"):
                try:
                    out.append(int(name.split("-")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, step: int, state: Any,
             sampler_state: Optional[dict] = None) -> None:
        """Write a snapshot; re-saving a step replaces it; then rotate.
        With shards every rank of the mesh calls it: the chunks are
        gathered and the first data rank writes."""
        shards = self.shards
        if shards is not None:
            whole = shards.gather_state(state)
            if shards.index == 0:
                self._write(step, whole, sampler_state)
            dist.barrier(group=shards.group)
        else:
            self._write(step, state, sampler_state)

    def _write(self, step: int, state: Any, sampler_state: Optional[dict]):
        path = self._path(step)
        if os.path.exists(path):
            shutil.rmtree(path)
        save_state(os.path.join(path, "state"), state)
        if sampler_state is not None:
            with open(os.path.join(path, "sampler.json"), "w") as f:
                json.dump(sampler_state, f)
        self._rotate()

    def _rotate(self):
        steps = self.steps()
        while len(steps) > self.max_to_keep:
            shutil.rmtree(self._path(steps.pop(0)), ignore_errors=True)

    def save_reference_format(self, step: int, state_dict, mmdit_cfg,
                              ema_state_dict=None) -> None:
        """Also export the transformer in the reference's diffusers layout
        (config.json + safetensors shards) under `transformer/` (and
        `transformer_ema/`), as the reference's save hook does
        (scripts/train.py:1121-1167). state_dict: {reference name: tensor},
        e.g. a module's state_dict() or a TrainState's float32 masters."""
        from ..models.convert import mmdit_config_json, save_reference_checkpoint

        path = self._path(step)
        cfg_json = mmdit_config_json(mmdit_cfg)
        save_reference_checkpoint(os.path.join(path, "transformer"),
                                  state_dict, cfg_json)
        if ema_state_dict is not None:
            save_reference_checkpoint(os.path.join(path, "transformer_ema"),
                                      ema_state_dict, cfg_json)

    def restore_latest(self, template: Any = None, device=None
                       ) -> Tuple[Any, Optional[dict], Optional[int]]:
        """(state, sampler_state, step) of the newest checkpoint that loads,
        or (None, None, None); a checkpoint that fails to load (a
        truncated file, a mismatched template) is passed over. With
        shards, this rank's chunks (load_state)."""
        if self.shards is not None:  # no rank reads before the writer is done
            dist.barrier(group=self.shards.group)
        for step in reversed(self.steps()):
            try:
                state = load_state(os.path.join(self._path(step), "state"),
                                   template, device, self.shards)
            except (OSError, ValueError, KeyError, TypeError) as e:
                print(f"checkpoint-{step} did not load ({type(e).__name__}: "
                      f"{e}); trying the previous one")
                continue
            sampler = None
            spath = os.path.join(self._path(step), "sampler.json")
            if os.path.exists(spath):
                with open(spath) as f:
                    sampler = json.load(f)
            return state, sampler, step
        return None, None, None
