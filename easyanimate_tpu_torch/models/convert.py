"""Weights into and out of the port's modules.

The port's parameter names are the reference (diffusers) state-dict keys,
so a reference-layout dict -- what the JAX package exports through
easyanimate_tpu/models/convert.py::export_mmdit_state_dict and
export_vae_state_dict -- loads as it is, with no key mapping and no
transposes. LoRA weights cross in the kohya format the reference's
utils/lora_utils.py reads and writes (and the JAX package's
export_lora_state_dict / convert_lora_state_dict): per targeted Linear
`lora_unet_<module path with dots as underscores>` with `.lora_down.weight`
(r, in), `.lora_up.weight` (out, r) and `.alpha`.
"""
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device


def load_reference_state_dict(module: nn.Module,
                              sd: Dict[str, np.ndarray]) -> None:
    """Load numpy arrays in the reference layout with strict=True: the whole
    dict of the module (e.g. the full VAE dict, encoder included, or the
    inpaint MMDiT's with its 33-channel proj), raising on anything missing
    or left over. Values are cast to each parameter's dtype and device."""
    module.load_state_dict(
        {k: torch.from_numpy(np.require(v, requirements=("C", "W")))
         for k, v in sd.items()},
        strict=True)


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter in place from `generator` (which must live on
    the parameters' device): norm weights 1, biases 0, every other tensor
    N(0, 1/fan_in). Used to drive the full-size model with random weights
    built directly on the device, e.g. after `to_empty`."""
    for name, p in module.named_parameters():
        if p.dim() == 1:
            is_norm_weight = name.endswith("weight")  # 1-D weights are norms
            p.fill_(1.0 if is_norm_weight else 0.0)
        else:
            fan_in = p[0].numel()
            p.normal_(0.0, fan_in ** -0.5, generator=generator)
    return module


LORA_PREFIX_TRANSFORMER = "lora_unet"  # reference utils/lora_utils.py:161
_LORA_KINDS = (".lora_down.weight", ".lora_up.weight", ".alpha")


def kohya_name(module_path: str) -> str:
    return LORA_PREFIX_TRANSFORMER + "_" + module_path.replace(".", "_")


def export_lora_state_dict(lora, alpha: float) -> Dict[str, np.ndarray]:
    """The port's LoRA ({module path: {'down': (in, r), 'up': (r, out)}})
    -> a kohya state dict of float32 numpy arrays: lora_down = down^T,
    lora_up = up^T."""
    out = {}
    for path, fac in sorted(lora.items()):
        name = kohya_name(path)
        out[name + ".lora_down.weight"] = np.ascontiguousarray(
            fac["down"].detach().float().cpu().numpy().T)
        out[name + ".lora_up.weight"] = np.ascontiguousarray(
            fac["up"].detach().float().cpu().numpy().T)
        out[name + ".alpha"] = np.asarray(alpha, np.float32)
    return out


def load_reference_lora_state_dict(module: nn.Module,
                                   sd: Dict[str, np.ndarray],
                                   device=None) -> Tuple[dict, "LoRAConfig"]:
    """A kohya LoRA state dict -> (LoRA for `module`, LoRAConfig), factors
    float32 on `device` (the card by default). Text-encoder factors (`lora_te*`) are skipped;
    a module the model does not have, a missing factor, or mixed ranks or
    alphas raise. An absent alpha means alpha = rank (kohya's convention)."""
    from ..training.lora import LoRAConfig

    paths = {kohya_name(p): p for p, m in module.named_modules()
             if isinstance(m, nn.Linear)}
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        kind = next((k for k in _LORA_KINDS if key.endswith(k)), None)
        if kind is None:
            raise ValueError(f"unrecognised LoRA key {key}")
        name = key[:-len(kind)]
        if name.startswith("lora_te"):
            continue
        if name not in paths:
            raise ValueError(f"LoRA module {name} has no Linear in this model")
        groups.setdefault(name, {})[kind] = np.asarray(value)
    if not groups:
        raise ValueError("state dict contained no transformer LoRA modules")
    device = resolve_device(device)
    lora, ranks, alphas = {}, set(), set()
    for name, g in groups.items():
        missing = {".lora_down.weight", ".lora_up.weight"} - set(g)
        if missing:
            raise ValueError(f"{name} missing {sorted(missing)}")
        down = torch.from_numpy(np.ascontiguousarray(
            g[".lora_down.weight"].astype(np.float32).T))
        up = torch.from_numpy(np.ascontiguousarray(
            g[".lora_up.weight"].astype(np.float32).T))
        ranks.add(down.shape[1])
        alphas.add(float(g.get(".alpha", down.shape[1])))
        lora[paths[name]] = {"down": down.to(device), "up": up.to(device)}
    if len(ranks) > 1 or len(alphas) > 1:
        raise ValueError(f"mixed LoRA ranks {sorted(ranks)} or alphas "
                         f"{sorted(alphas)} unsupported")
    return lora, LoRAConfig(rank=ranks.pop(), alpha=alphas.pop())
