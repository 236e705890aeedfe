"""Checkpoint loader: a reference model directory -> a ready pipeline.

Parity: easyanimate_tpu/loader.py. Consumes the layout the reference
downloads from HF (alibaba-pai/EasyAnimateV5.1-*): transformer/config.json
+ diffusion_pytorch_model*.safetensors, vae/..., scheduler/
scheduler_config.json (predict_t2v.py:91-254 load spine). The port's
parameter names are the reference keys, so the files load as they are,
through the port's own safetensors reader: neither `safetensors` nor
`transformers` nor `yaml` is imported on this path.

Pipelines: "t2v", "inpaint" and "control"; the scheduler comes from the
directory's scheduler_config.json or the `scheduler` argument, as JAX's
(:322-342). The block linears may be held quantized (W8A8 int8, or packed
int4 computing as W4A8 or W4A16; ops/quant.py), as JAX's :268-301. The
text stacks (load_text_encoders, JAX :154-213): V5.1's Qwen2-VL, V5's Bert
+ mT5 dual stream and the single T5 / mT5 stream. The VAE's chunk mode is
`cache_mag` or `slice_mag` (V4's); the others raise NotImplementedError
with their ROADMAP queue 1 item (8). As JAX's, the loader builds the MMDiT
only: a V4 transformer is built from its yaml (utils/config.py). The
pipeline gets the TeaCache polynomial of its model path, as JAX's does
(:349-355).
"""
import dataclasses
import os
from typing import Optional

from .device import resolve_device
from .models.convert import load_on_device, read_json
from .models.mmdit import EasyAnimateTransformer3D, MMDiTConfig
from .models.vae import AutoencoderKLMagvit, MagvitVAEConfig
from .pipeline import (DDIMConfig, EasyAnimateControlPipeline,
                       EasyAnimateInpaintPipeline, EasyAnimatePipeline,
                       FlowMatchEulerConfig)
from .pipeline.t2v import get_teacache_coefficients
from .utils.fp8 import quantize_module_fp8_
from .utils.safetensors_io import load_dir, load_file

_PIPELINES = {"t2v": EasyAnimatePipeline,
              "inpaint": EasyAnimateInpaintPipeline,
              "control": EasyAnimateControlPipeline}


def _override_state_dict(base_sd: dict, ckpt_path: Optional[str],
                         what: str) -> dict:
    """Overlay a component checkpoint file onto a base state dict
    (reference predict_t2v.py:110-119 `load_state_dict(state_dict,
    strict=False)`): keys present in the file override, keys missing keep
    the base weights, unexpected keys are reported and dropped."""
    if ckpt_path is None:
        return base_sd
    if not ckpt_path.endswith("safetensors"):
        raise ValueError(f"{what}_path must be a .safetensors file "
                         f"(got {ckpt_path!r})")
    sd = load_file(ckpt_path)
    unexpected = [k for k in sd if k not in base_sd]
    missing = sum(1 for k in base_sd if k not in sd)
    print(f"From checkpoint: {ckpt_path} ({what}) — "
          f"missing keys: {missing}, unexpected keys: {len(unexpected)}")
    return {**base_sd, **{k: v for k, v in sd.items() if k in base_sd}}


def mmdit_config_from_json(cfg: dict, dtype: str = "bfloat16") -> MMDiTConfig:
    """Map a reference transformer config.json to MMDiTConfig."""
    return MMDiTConfig(
        num_attention_heads=cfg.get("num_attention_heads", 48),
        attention_head_dim=cfg.get("attention_head_dim", 64),
        in_channels=cfg.get("in_channels", 16),
        out_channels=cfg.get("out_channels", 16),
        patch_size=cfg.get("patch_size", 2),
        num_layers=cfg.get("num_layers", 48),
        mmdit_layers=cfg.get("mmdit_layers", 10000),
        swa_layers=cfg.get("swa_layers"),
        time_embed_dim=cfg.get("time_embed_dim", 512),
        text_embed_dim=cfg.get("text_embed_dim", 3584),
        text_embed_dim_t5=cfg.get("text_embed_dim_t5"),
        add_norm_text_encoder=cfg.get("add_norm_text_encoder", False),
        after_norm=cfg.get("after_norm", False),
        norm_eps=cfg.get("norm_eps", 1e-5),
        time_position_encoding_type=cfg.get(
            "time_position_encoding_type", "3d_rope"),
        ref_channels=cfg.get("ref_channels"),
        clip_channels=cfg.get("clip_channels"),
        add_ref_latent_in_control_model=cfg.get(
            "add_ref_latent_in_control_model", False),
        resize_inpaint_mask_directly=cfg.get(
            "resize_inpaint_mask_directly", True),
        add_noise_in_inpaint_model=cfg.get("add_noise_in_inpaint_model", True),
        dtype=dtype,
    )


VAE_CHUNK_FLAGS = (("cache_mag_vae", "cache_mag"), ("slice_mag_vae", "slice_mag"),
                   ("cache_compression_vae", "cache_compression"),
                   ("slice_compression_vae", "slice_compression"))


def vae_config_from_json(cfg: dict, dtype: str = "bfloat16") -> MagvitVAEConfig:
    chunk_mode = next((mode for flag, mode in VAE_CHUNK_FLAGS if cfg.get(flag)),
                      "none")
    return MagvitVAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 16),
        block_out_channels=tuple(cfg.get("block_out_channels",
                                         (128, 256, 512, 512))),
        down_block_types=_parse_types(cfg.get("down_block_types"),
                                      MagvitVAEConfig.down_block_types),
        # JAX defaults the up blocks to the DOWN block names, which its own
        # decoder then rejects (KeyError in _UP_KIND); the port defaults
        # them to the up names
        up_block_types=_parse_types(cfg.get("up_block_types"),
                                    MagvitVAEConfig.up_block_types),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        mid_block_attention_type=cfg.get("mid_block_attention_type", "spatial"),
        mid_block_use_attention=cfg.get("mid_block_use_attention", True),
        spatial_group_norm=cfg.get("spatial_group_norm", True),
        mini_batch_encoder=cfg.get("mini_batch_encoder", 4),
        mini_batch_decoder=cfg.get("mini_batch_decoder", 1),
        scaling_factor=cfg.get("scaling_factor", 0.7119),
        chunk_mode=chunk_mode,
        # 4 latent frames per cache_mag decoder pass, JAX's serving default
        # (the causal caches make the pass size irrelevant to the result;
        # slice_mag's chunk is mini_batch_decoder whatever this is)
        decode_chunk_frames=cfg.get("decode_chunk_frames",
                                    4 if chunk_mode == "cache_mag" else None),
        tile_sample_min_size=cfg.get("tile_sample_min_size", 384),
        tile_overlap_factor=cfg.get("tile_overlap_factor", 0.25),
        dtype=dtype,
    )


def _parse_types(v, default):
    if v is None:
        return tuple(default)
    if isinstance(v, str):  # the reference stores a python-tuple string
        return tuple(x.strip().strip("'\"")
                     for x in v.strip("()").split(",") if x.strip())
    return tuple(v)


def load_text_encoders(model_path: Optional[str] = None,
                       text_encoder_path: Optional[str] = None,
                       text_encoder_2_path: Optional[str] = None,
                       max_length: int = 256, device=None):
    """The prompt-encoding callable of a model directory, on `device` (the
    card by default): encode(prompts) -> {"text": [B, S, D]}, and V5's
    {"text_t5": [B, S_t5, D_t5]} beside it. The stack comes from
    text_encoder/config.json's model_type (the reference's load spine,
    predict_t2v.py:91-254):
      qwen2 / qwen2_vl (V5.1)                     -> one stream, max_length
      bert (+ text_encoder_2's mT5, V4 / V5)      -> Bert at its 77 tokens,
                                                     mT5 at max_length
      t5 / mt5 (V1-V3)                            -> one stream, max_length
    umt5 raises NotImplementedError (T5Config.from_json: a bias table in
    every block). Prompt strings need each directory's tokenizer files."""
    te = text_encoder_path or (model_path and
                               os.path.join(model_path, "text_encoder"))
    if not te or not os.path.isdir(te):
        raise FileNotFoundError(
            f"no text encoder at {te!r}; pass text_encoder_path")
    te2 = text_encoder_2_path or (model_path and
                                  os.path.join(model_path, "text_encoder_2"))
    model_type = read_json(os.path.join(te, "config.json")).get(
        "model_type", "")

    from .models.text.encoders import build_text_encoder

    if model_type.startswith("qwen2"):
        enc = build_text_encoder("qwen2_vl", te, max_length=max_length,
                                 device=device)
        return lambda prompts: {"text": enc(list(prompts))[0]}
    if model_type == "bert":
        if not (te2 and os.path.isdir(te2)):
            raise FileNotFoundError(
                "bert text encoder needs the mT5 text_encoder_2 directory")
        bert = build_text_encoder("bert", te, device=device)
        mt5 = build_text_encoder("mt5", te2, max_length=max_length,
                                 device=device)
        return lambda prompts: {"text": bert(list(prompts))[0],
                                "text_t5": mt5(list(prompts))[0]}
    if model_type in ("t5", "mt5", "umt5"):
        mt5 = build_text_encoder("mt5", te, max_length=max_length,
                                 device=device)
        return lambda prompts: {"text": mt5(list(prompts))[0]}
    raise ValueError(f"unrecognized text encoder model_type {model_type!r}")


def _scheduler(model_path: str, scheduler: Optional[str]):
    """JAX's rule: "flow", or None with a FlowMatch config, gives FlowMatch;
    "ddim", or None without one, DDIM from the config's betas and
    prediction type; any other string FlowMatch's defaults (JAX's quirk,
    kept: a sampler name belongs in make_scheduler)."""
    path = os.path.join(model_path, "scheduler", "scheduler_config.json")
    scfg = read_json(path) if os.path.exists(path) else {}
    flow = "FlowMatch" in scfg.get("_class_name", "")
    if scheduler == "flow" or (scheduler is None and flow):
        return FlowMatchEulerConfig(
            num_train_timesteps=scfg.get("num_train_timesteps", 1000),
            shift=scfg.get("shift", 3.0),
            use_dynamic_shifting=scfg.get("use_dynamic_shifting", True))
    if scheduler in ("ddim", None):
        return DDIMConfig(
            num_train_timesteps=scfg.get("num_train_timesteps", 1000),
            beta_start=scfg.get("beta_start", 0.0001),
            beta_end=scfg.get("beta_end", 0.02),
            beta_schedule=scfg.get("beta_schedule", "scaled_linear"),
            prediction_type=scfg.get("prediction_type", "epsilon"))
    return FlowMatchEulerConfig()


def load_pipeline(model_path: str, pipeline_type: str = "t2v",
                  dtype: str = "bfloat16", fp8_weights: bool = False,
                  int8_linears: bool = False, int4_weights: bool = False,
                  int4_compute: str = "int8",
                  scheduler: Optional[str] = None, strict: bool = True,
                  transformer_path: Optional[str] = None,
                  vae_path: Optional[str] = None, device=None):
    """Build a ready pipeline ("t2v", "inpaint" or "control") from a
    reference-format model directory, on `device` (the card by default).
    A control model's config.json carries its proj input channels (16
    latents + 16 control video or 6 camera + 16 reference) and
    add_ref_latent_in_control_model (its ref_proj), so its files load
    strictly like any other.

    The modules are built on meta, checked against the files with
    load_state_dict(strict=True) (every name and shape), allocated with
    to_empty on the device and filled tensor by tensor from the memory-
    mapped files: no host copy of the weights is made. strict=False drops
    keys the model does not have instead of raising; a missing key always
    raises (there is nothing to fill it with). fp8_weights=True holds the
    transformer's >= 2-D weights as float8_e4m3fn, cast once from the
    files' dtype. transformer_path / vae_path overlay a component
    safetensors checkpoint on the base directory (the reference predict
    scripts' knobs of the same names).

    int8_linears=True holds the block linears as W8A8 int8 (per-out-channel
    weights, per-token activations); int4_weights=True as group-128 packed
    int4 (a quarter of the bf16 bytes), exclusive with it, multiplying as
    int4_compute "int8" (W4A8, the default) or "bf16" (W4A16). Each block
    linear is quantized on the device as it is filled from the file, so
    the float transformer is never whole on the card; fp8_weights composes
    with either (the rest of the transformer in fp8, the scales float32)."""
    if int8_linears and int4_weights:
        raise ValueError("int8_linears and int4_weights are exclusive")
    if int4_compute not in ("int8", "bf16"):
        raise ValueError(f"int4_compute must be int8|bf16, got {int4_compute}")
    int4_mode = "w4a8" if int4_compute == "int8" else "int4"
    quant = "int8" if int8_linears else (int4_mode if int4_weights else None)
    cls = _PIPELINES[pipeline_type]
    device = resolve_device(device)
    sched = _scheduler(model_path, scheduler)
    mmdit_cfg = dataclasses.replace(mmdit_config_from_json(
        read_json(os.path.join(model_path, "transformer", "config.json")),
        dtype), linear_quant=quant)
    vae_cfg = vae_config_from_json(
        read_json(os.path.join(model_path, "vae", "config.json")), dtype)

    transformer = EasyAnimateTransformer3D(mmdit_cfg, device="meta")
    vae = AutoencoderKLMagvit(vae_cfg, device="meta")
    if fp8_weights:
        quantize_module_fp8_(transformer, mmdit_cfg.torch_dtype)
    for module, sub, override in ((transformer, "transformer",
                                   transformer_path), (vae, "vae", vae_path)):
        sd = _override_state_dict(load_dir(os.path.join(model_path, sub)),
                                  override, sub)
        if not strict:
            names = set(module.state_dict())
            sd = {k: v for k, v in sd.items() if k in names}
        load_on_device(module, sd, device)
    pipe = cls(transformer, vae, device, scheduler=sched)
    # matched on the full model path, as the reference does (ui.py:477); a
    # model without a polynomial gets None, and TeaCache stays off for it
    pipe.teacache_coefficients = get_teacache_coefficients(model_path)
    return pipe
