"""LoRA for the MMDiT: kohya-form hooks for training, weight merging for
inference.

Parity: easyanimate_tpu/training/lora.py. A LoRA is a dict keyed by the
reference module path of each targeted Linear, e.g.
`transformer_blocks.0.attn1.to_q`, holding float32 factors
{'down': (in, r), 'up': (r, out)} -- the JAX package's factor orientation
-- with `up` zero-initialised, so the LoRA starts as the identity.

Departure from the JAX step, and why: the JAX step merges
kernel + coef * down @ up into every targeted kernel on every step
(easyanimate_tpu/training/lora.py:119-121). At 12B on one card that would
materialise a second copy of every targeted weight (~21 GB in bf16) and
round the small delta into bf16 weights. The port trains in the
reference's own form instead, the kohya hook of utils/lora_utils.py:
base(x) + coef * (x @ down) @ up on each targeted Linear (attach_lora),
which is the same function with the same gradients. merge_lora stays for
inference.
"""
import contextlib
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.quant import QuantLinear
from . import optim
from .losses import masked_mse_loss
from .trainer import (TrainConfig, TrainState, draw_flow_inputs,
                      flow_prediction, make_optimizer)

LoRA = Dict[str, Dict[str, torch.Tensor]]

# the modules the JAX DEFAULT_TARGETS selects (attention q/k/v/out of both
# streams, both FFN linears of both streams), by reference module path
# (easyanimate_tpu/models/convert.py::_block_mapping)
DEFAULT_TARGETS = (r"transformer_blocks\.\d+\.(attn1|attn2)\.(to_[qkv]|to_out\.0)$"
                   r"|transformer_blocks\.\d+\.(txt_ff|ff)\.net\.(0\.proj|2)$")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 32
    alpha: float = 16.0
    targets: str = DEFAULT_TARGETS
    init_std: float = 0.01

    @property
    def coef(self) -> float:
        return self.alpha / self.rank


def target_modules(model: nn.Module, cfg: LoRAConfig) -> Dict[str, nn.Module]:
    """{module path: Linear or QuantLinear} for the linears whose path
    matches cfg.targets, in path order."""
    return {path: mod for path, mod in sorted(model.named_modules())
            if isinstance(mod, (nn.Linear, QuantLinear))
            and re.search(cfg.targets, path)}


def lora_init(model: nn.Module, cfg: LoRAConfig,
              generator: Optional[torch.Generator] = None) -> LoRA:
    """Factors for every targeted Linear, float32 on its weight's device:
    down ~ N(0, init_std), up = 0 (easyanimate_tpu lora.py:53-55).
    `generator` must live on that device."""
    lora = {}
    for path, mod in target_modules(model, cfg).items():
        dev = mod.weight.device
        down = cfg.init_std * torch.randn(mod.in_features, cfg.rank,
                                          generator=generator, device=dev)
        up = torch.zeros(cfg.rank, mod.out_features, device=dev)
        lora[path] = {"down": down, "up": up}
    return lora


@torch.no_grad()
def merge_lora(model: nn.Module, lora: LoRA, cfg: LoRAConfig,
               scale: float = 1.0) -> nn.Module:
    """weight += scale * coef * (down @ up)^T in place, summed in float32 and
    rounded once to the weight's dtype (bf16 or float32). A quantized
    weight (ops/quant.py::QuantLinear, int8 or packed int4) merges in
    dequantized space and is requantized with fresh scales, as JAX's
    (easyanimate_tpu/training/lora.py:60-90): a merge and its unmerge then
    carry only quantization error."""
    coef = scale * cfg.coef
    for path, fac in lora.items():
        mod = model.get_submodule(path)
        delta = (fac["down"].float() @ fac["up"].float()).t() * coef
        if isinstance(mod, QuantLinear):
            mod.set_weight_(mod.dequantized_weight()
                            + delta.to(mod.weight.device))
            continue
        w = mod.weight
        w.copy_((w.float() + delta.to(w.device)).to(w.dtype))
    return model


def unmerge_lora(model: nn.Module, lora: LoRA, cfg: LoRAConfig,
                 scale: float = 1.0) -> nn.Module:
    return merge_lora(model, lora, cfg, scale=-scale)


@contextlib.contextmanager
def attach_lora(model: nn.Module, lora: LoRA, cfg: LoRAConfig,
                scale: float = 1.0):
    """Within the block, each targeted Linear returns
    base(x) + scale * coef * (x @ down) @ up (the kohya hook,
    utils/lora_utils.py), with the factors cast to x's dtype; autograd
    reaches the factors. A backward that recomputes blocks (remat) must run
    inside the block too."""
    coef = scale * cfg.coef

    def hook(down, up):
        def add_branch(module, args, out):
            x = args[0]
            return out + (x @ down.to(x.dtype)) @ up.to(x.dtype) * coef
        return add_branch

    handles = [model.get_submodule(path).register_forward_hook(
        hook(fac["down"], fac["up"])) for path, fac in lora.items()]
    try:
        yield model
    finally:
        for h in handles:
            h.remove()


def flatten_lora(lora: LoRA) -> Dict[str, torch.Tensor]:
    """{'path/down': t, 'path/up': t}: the same tensors, flat."""
    return {f"{path}/{kind}": t for path, fac in lora.items()
            for kind, t in fac.items()}


def make_lora_train_step(model: nn.Module, train_cfg: TrainConfig,
                         lora_cfg: LoRAConfig) -> Tuple[Callable, Callable]:
    """Returns (init_fn, step_fn); only the LoRA factors train, the base
    parameters are frozen (requires_grad off) and never change.

    init_fn(generator=None, lora=None) -> TrainState whose params are the
    LoRA (lora_init from `generator`, or the given factors, e.g. from
    load_reference_lora_state_dict). step(state, batch, generator=None,
    draws=None) -> (state, metrics) updates the factors in place."""
    model.requires_grad_(False)
    tx = make_optimizer(train_cfg)

    def init_fn(generator=None, lora=None) -> TrainState:
        if lora is None:
            lora = lora_init(model, lora_cfg, generator)
        for t in flatten_lora(lora).values():
            t.requires_grad_(True)
        return TrainState(step=0, params=lora,
                          opt_state=tx.init(flatten_lora(lora)))

    def step(state: TrainState, batch, generator=None, draws=None):
        if draws is None:
            draws = draw_flow_inputs(generator, batch["latents"], train_cfg.loss)
        flat = flatten_lora(state.params)
        for t in flat.values():
            t.grad = None
        with attach_lora(model, state.params, lora_cfg):
            pred, target = flow_prediction(model, batch, draws)
            loss = masked_mse_loss(pred, target,
                                   train_cfg.loss.loss_outlier_threshold)
            loss.backward()
        # the last block's text stream never reaches the loss: zero, as JAX
        grads = {k: torch.zeros_like(t) if t.grad is None else t.grad
                 for k, t in flat.items()}
        metrics = {"loss": loss.detach(), "grad_norm": optim.global_norm(grads)}
        updates, opt_state = tx.update(grads, state.opt_state, flat)
        optim.apply_updates(flat, updates)
        for t in flat.values():
            t.grad = None
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return init_fn, step


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_lora(path: str, lora: LoRA, cfg: LoRAConfig) -> None:
    """A flat .npz ('module.path/down', '.../up', float32) plus the config
    in a sidecar json, under the JAX package's names
    (easyanimate_tpu/training/lora.py::save_lora): `x` -> x.npz + x.json,
    `x.npz` -> x.npz + x.npz.json."""
    np.savez(_npz_path(path), **{k: t.detach().float().cpu().numpy()
                                 for k, t in flatten_lora(lora).items()})
    with open(path + ".json", "w") as f:
        json.dump({"rank": cfg.rank, "alpha": cfg.alpha,
                   "targets": cfg.targets}, f)


def load_lora(path: str, device=None) -> Tuple[LoRA, LoRAConfig]:
    """save_lora's files, or the JAX package's, -> (LoRA with float32
    factors on `device`, the card by default; LoRAConfig). The config is
    read from `<path>.json`, the name save_lora(path) writes, else from the
    other layout's name (`x` <-> `x.npz`), so both layouts of either
    package load."""
    npz = _npz_path(path)
    meta_path = path + ".json"
    if not os.path.exists(meta_path):
        meta_path = (npz if npz != path else path[:-len(".npz")]) + ".json"
    device = resolve_device(device)
    lora: LoRA = {}
    with np.load(npz) as data:
        for k in data.files:
            mod, kind = k.rsplit("/", 1)
            lora.setdefault(mod, {})[kind] = torch.from_numpy(data[k]).to(device)
    with open(meta_path) as f:
        meta = json.load(f)
    return lora, LoRAConfig(rank=meta["rank"], alpha=meta["alpha"],
                            targets=meta["targets"])
