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

On disk the port reads and writes diffusers-layout folders (config.json +
safetensors shards + the `.index.json` weight map) through its own
safetensors reader and writer (utils/safetensors_io.py).
"""
import json
import os
import warnings
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.quant import QuantLinear
from ..utils.safetensors_io import load_file, save_file


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


def load_on_device(module: nn.Module, sd: Mapping[str, torch.Tensor],
                   device=None) -> nn.Module:
    """Strict load of `sd` into `module`, built on meta: load_state_dict
    (strict=True) on meta checks every name and shape and copies nothing,
    to_empty allocates the parameters on `device` (the card by default),
    then each tensor is copied in, cast to its parameter's dtype. With `sd`
    memory-mapped (safetensors_io.load_file) no host copy of the weights is
    made."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*meta parameter.*no-op")
        module.load_state_dict(sd, strict=True)
    module.to_empty(device=resolve_device(device))
    module.load_state_dict(sd, strict=True)
    return module


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (a nested dict of arrays) -> the port's state dict under
    the dotted paths: Dense kernels (in, out) -> weights (out, in), a conv's
    HWIO -> OIHW, norm scale -> weight, Embed embedding -> weight. The
    parameter names of the CLIP scorers and of the Bert and mT5 towers are
    the Flax paths, so nothing else is renamed; keys a module lacks (Bert's
    pooler) are left for its loader to drop by name."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            a = np.array(v, dtype=np.float32)
            name = ".".join(path)
            if k == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                k = "weight"
            elif k in ("scale", "embedding"):
                k = "weight"
            out[f"{name}.{k}" if name else k] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(params, ())
    return out


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter in place from `generator` (which must live on
    the parameters' device): norm weights 1, biases 0, every other tensor
    N(0, 1/fan_in); a scalar (CLIP's logit_scale) keeps its value. Used to
    drive the full-size model with random weights built directly on the
    device, e.g. after `to_empty`."""
    for name, p in module.named_parameters():
        if p.dim() == 0:
            continue
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
             if isinstance(m, (nn.Linear, QuantLinear))}
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


def save_lora_reference(path: str, lora, alpha: float) -> None:
    """Write a kohya-format LoRA safetensors file (the reference's
    `lora_diffusion_pytorch_model.safetensors`, scripts/train_lora.py:1552;
    JAX models/convert.py:718)."""
    save_file(export_lora_state_dict(lora, alpha), path)


def load_lora_reference(module: nn.Module, path: str, device=None):
    """A kohya-format LoRA safetensors file -> (LoRA, LoRAConfig), as
    load_reference_lora_state_dict."""
    return load_reference_lora_state_dict(
        module, {k: v.numpy() for k, v in load_file(path).items()}, device)


def _refuse_quantized() -> None:
    # JAX export_mmdit_state_dict (easyanimate_tpu/models/convert.py:471)
    raise ValueError("export needs a float transformer: quantized block "
                     "linears cannot be converted back losslessly (train "
                     "and EMA weights are float; quantization is a serving-"
                     "time transform)")


def mmdit_config_json(cfg) -> Dict:
    """MMDiTConfig -> reference transformer config.json fields (the inverse
    of loader.mmdit_config_from_json; JAX models/convert.py:726). A config
    with quantized block linears raises, as JAX's export does."""
    if cfg.linear_quant:
        _refuse_quantized()
    return {
        "_class_name": "EasyAnimateTransformer3DModel",
        "num_attention_heads": cfg.num_attention_heads,
        "attention_head_dim": cfg.attention_head_dim,
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "patch_size": cfg.patch_size,
        "num_layers": cfg.num_layers,
        "mmdit_layers": cfg.mmdit_layers,
        "swa_layers": list(cfg.swa_layers) if cfg.swa_layers else None,
        "time_embed_dim": cfg.time_embed_dim,
        "text_embed_dim": cfg.text_embed_dim,
        "text_embed_dim_t5": cfg.text_embed_dim_t5,
        "add_norm_text_encoder": cfg.add_norm_text_encoder,
        "after_norm": cfg.after_norm,
        "norm_eps": cfg.norm_eps,
        "time_position_encoding_type": cfg.time_position_encoding_type,
        "ref_channels": cfg.ref_channels,
        "clip_channels": cfg.clip_channels,
        "add_ref_latent_in_control_model": cfg.add_ref_latent_in_control_model,
        "resize_inpaint_mask_directly": cfg.resize_inpaint_mask_directly,
        "add_noise_in_inpaint_model": cfg.add_noise_in_inpaint_model,
    }


def save_reference_checkpoint(directory: str, state_dict: Mapping[str, object],
                              config_json: Dict = None,
                              max_shard_bytes: int = 30 * 10 ** 9,
                              weights_name: str =
                              "diffusion_pytorch_model.safetensors"):
    """Write a diffusers-layout folder: config.json + safetensors shard(s)
    with the standard `.index.json` weight map when sharded (reference
    save_pretrained(max_shard_size="30GB"), scripts/train.py:1126; JAX
    models/convert.py:754). Values are torch tensors (any device) or numpy
    arrays, written in their own dtype. Returns the shard file names. The
    state of a quantized model (a QuantLinear's `scale` beside its int8
    `weight`) raises: the reference layout holds float weights."""
    for k in state_dict:
        w = state_dict.get(k[:-len("scale")] + "weight")
        if k.endswith(".scale") and w is not None and str(w.dtype) in (
                "int8", "torch.int8"):
            _refuse_quantized()
    os.makedirs(directory, exist_ok=True)
    if config_json is not None:
        with open(os.path.join(directory, "config.json"), "w") as f:
            json.dump(config_json, f, indent=2)

    def nbytes(v):
        return v.numel() * v.element_size() if torch.is_tensor(v) else v.nbytes

    shards, cur, cur_bytes = [], {}, 0
    for k in sorted(state_dict):
        v = state_dict[k]
        if cur and cur_bytes + nbytes(v) > max_shard_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += nbytes(v)
    shards.append(cur)

    if len(shards) == 1:
        save_file(shards[0], os.path.join(directory, weights_name))
        return [weights_name]
    stem, ext = weights_name.rsplit(".", 1)
    names, weight_map, total = [], {}, 0
    for i, shard in enumerate(shards):
        name = f"{stem}-{i + 1:05d}-of-{len(shards):05d}.{ext}"
        save_file(shard, os.path.join(directory, name))
        names.append(name)
        for k, v in shard.items():
            weight_map[k] = name
            total += nbytes(v)
    with open(os.path.join(directory, f"{weights_name}.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return names


# JAX's quantized block linears (the _QUANT_PARENTS of easyanimate_tpu/
# ops/quant.py, under their block subtree) -> the port's module paths
_JAX_QUANT_LINEARS = {
    **{f"{attn}/to_{p}": f"{attn}.to_{p}" for attn in ("attn1", "attn2")
       for p in "qkv"},
    "attn1_out": "attn1.to_out.0", "attn2_out": "attn2.to_out.0",
    "ff/wi": "ff.net.0.proj", "ff/wo": "ff.net.2",
    "txt_ff/wi": "txt_ff.net.0.proj", "txt_ff/wo": "txt_ff.net.2"}


def _flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_layer_regions(flat: Dict[str, np.ndarray]):
    """[(tree prefix, first layer, layer count, stacked)] of a JAX MMDiT
    tree, read from its names: one scan stack `blocks/block`, segmented
    stacks `blocks_seg{k}/block` between single layers `block{i}`, or
    `block{i}` alone (JAX models/convert.py::_mmdit_layer_regions)."""
    tops = {key.split("/", 1)[0] for key in flat}
    if "blocks" in tops:
        n = flat["blocks/block/norm1/linear/kernel"].shape[0]
        return [("blocks/block", 0, n, True)]
    regions, layer, seg = [], 0, 0
    while True:
        if f"blocks_seg{seg}" in tops:
            prefix = f"blocks_seg{seg}/block"
            n = flat[f"{prefix}/norm1/linear/kernel"].shape[0]
            regions.append((prefix, layer, n, True))
        elif f"block{layer}" in tops:
            n = 1
            regions.append((f"block{layer}", layer, 1, False))
        else:
            return regions
        layer, seg = layer + n, seg + 1


def quantized_linears_from_jax(params) -> Dict[str, torch.Tensor]:
    """The quantized block linears of a JAX tree from quantize_params_int8
    or quantize_params_int4 (easyanimate_tpu/ops/quant.py; nested dicts of
    numpy arrays, with or without the 'params' level) -> the port's state
    entries for them: `transformer_blocks.<i>.<linear>.weight`, JAX's int8
    kernel [in, out] or packed [in // 2, out] transposed, and `.scale`,
    its [out] or [groups, out] transposed. The rest of such a tree is float
    and crosses in the reference layout like any other weight."""
    flat = _flatten_tree(params.get("params", params))
    out = {}
    for prefix, first, count, stacked in _jax_layer_regions(flat):
        for jpath, path in _JAX_QUANT_LINEARS.items():
            kern = flat.get(f"{prefix}/{jpath}/kernel")
            if kern is None:
                continue
            scale = flat[f"{prefix}/{jpath}/scale"]
            if kern.dtype != np.int8:
                raise ValueError(f"{prefix}/{jpath}/kernel is {kern.dtype}, "
                                 "not a quantized kernel")
            for i in range(count):
                k, s = (kern[i], scale[i]) if stacked else (kern, scale)
                name = f"transformer_blocks.{first + i}.{path}"
                out[name + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(k.T))
                out[name + ".scale"] = torch.from_numpy(
                    np.ascontiguousarray(s.astype(np.float32).T))
    return out
