"""YAML model configs -> the port's modules.

Parity: easyanimate_tpu/utils/config.py (the reference's OmegaConf yamls,
config/*.yaml, with transformer_additional_kwargs / vae_kwargs consumed at
train.py:944-1036 and predict_*.py:91-141). The V5 and V5.1 types are
ported: EasyAnimateTransformer3DModel (V5's yaml sets its two text streams,
config/easyanimate_video_v5_magvit_multi_text_encoder.yaml:3-8) and
AutoencoderKLMagvit with the `cache_mag` chunk mode. The legacy
transformers and the other VAEs raise (ROADMAP queue 1 item 11), as do the
other chunk modes (item 8). `yaml` is imported inside load_yaml_config
only.
"""
import dataclasses
from typing import Any, Dict

from ..loader import VAE_CHUNK_FLAGS, check_vae_chunk_mode
from ..models.mmdit import EasyAnimateTransformer3D, MMDiTConfig
from ..models.vae import AutoencoderKLMagvit, MagvitVAEConfig


def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _filter_fields(cls, kw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names}


def build_transformer(config: Dict[str, Any], dtype: str = "bfloat16",
                      device=None, **overrides):
    """transformer_additional_kwargs (+ checkpoint config.json fields) ->
    (module on `device`, the card by default; config)."""
    kw = dict(config.get("transformer_additional_kwargs", config))
    kw.update(overrides)
    t_type = kw.pop("transformer_type", "EasyAnimateTransformer3DModel")
    if t_type == "EasyAnimateTransformer3DModel":
        cfg = MMDiTConfig(dtype=dtype, **_filter_fields(MMDiTConfig, kw))
        return EasyAnimateTransformer3D(cfg, device=device), cfg
    if t_type in ("HunyuanTransformer3DModel", "Transformer3DModel"):
        raise NotImplementedError(f"transformer_type {t_type!r} (V1-V4) is "
                                  "not ported (ROADMAP queue 1 item 11)")
    raise ValueError(f"unknown transformer_type {t_type}")


def build_vae(config: Dict[str, Any], dtype: str = "float32", device=None,
              **overrides):
    """vae_kwargs -> (module on `device`, the card by default; config).
    Takes this repo's `chunk_mode` or the reference's boolean flags
    (train.py:1006-1027)."""
    kw = dict(config.get("vae_kwargs", config))
    kw.update(overrides)
    v_type = kw.pop("vae_type", "AutoencoderKLMagvit")
    if "chunk_mode" not in kw:
        for flag, mode in VAE_CHUNK_FLAGS:
            if kw.pop(flag, False):
                kw["chunk_mode"] = mode
    if v_type == "AutoencoderKLMagvit":
        check_vae_chunk_mode(kw.get("chunk_mode", "cache_mag"))
        cfg = MagvitVAEConfig(dtype=dtype,
                              **_filter_fields(MagvitVAEConfig, kw))
        return AutoencoderKLMagvit(cfg, device=device), cfg
    if v_type in ("AutoencoderKL", "AutoencoderKLCogVideoX"):
        raise NotImplementedError(f"vae_type {v_type!r} is not ported "
                                  "(ROADMAP queue 1 item 11)")
    raise ValueError(f"unknown vae_type {v_type}")
