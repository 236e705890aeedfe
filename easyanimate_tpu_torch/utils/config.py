"""YAML model configs -> the port's modules.

Parity: easyanimate_tpu/utils/config.py (the reference's OmegaConf yamls,
config/*.yaml, with transformer_additional_kwargs / vae_kwargs consumed at
train.py:944-1036 and predict_*.py:91-141). Ported: the V5 and V5.1 type
EasyAnimateTransformer3DModel (V5's yaml sets its two text streams,
config/easyanimate_video_v5_magvit_multi_text_encoder.yaml:3-8), V4's
HunyuanTransformer3DModel (config/easyanimate_video_v4_slicevae_multi_
text_encoder.yaml), the V1-V3 Transformer3DModel (config/easyanimate_
video_v{1,2,3}_*.yaml: the motion modules' kwargs, the grid, the patch
flags), AutoencoderKLMagvit in the `cache_mag` and `slice_mag` chunk modes
and V1's 2D AutoencoderKL. The cogvideox VAE raises (ROADMAP queue 1 item
11.b), as do the other chunk modes (item 8). `yaml` is imported inside
load_yaml_config only.
"""
import dataclasses
from typing import Any, Dict

from ..loader import VAE_CHUNK_FLAGS
from ..models.hunyuan import HunyuanConfig, HunyuanTransformer3D
from ..models.mmdit import EasyAnimateTransformer3D, MMDiTConfig
from ..models.transformer3d_legacy import (MotionModuleConfig, Transformer3D,
                                           Transformer3DConfig)
from ..models.vae import (AutoencoderKL, AutoencoderKLMagvit, KL2DConfig,
                          MagvitVAEConfig)


def load_yaml_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def _filter_fields(cls, kw: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in kw.items() if k in names}


def _transformer3d_fields(kw: Dict[str, Any]) -> Dict[str, Any]:
    """Transformer3DModel's yaml kwargs -> Transformer3DConfig's fields, as
    JAX's build_transformer maps them (utils/config.py:61-89): the motion
    modules' kwargs per parity (motion_module_kwargs_{even,odd}, falling
    back to motion_module_kwargs) with `grid` from motion_module_type
    "VanillaGrid", and the reference's patch_3d / fake_3d / casual_3d
    flags as patch_mode."""
    kw = dict(kw)
    grid = kw.get("motion_module_type") == "VanillaGrid"
    fields = {}
    for side in ("even", "odd"):
        mk = kw.pop(f"motion_module_kwargs_{side}",
                    kw.get("motion_module_kwargs"))
        if mk:
            fields[f"motion_module_{side}"] = MotionModuleConfig(
                **_filter_fields(MotionModuleConfig, dict(mk, grid=grid)))
    if "patch_mode" not in kw:
        if kw.pop("casual_3d", False):
            kw["patch_mode"] = "casual_3d"
        elif kw.get("patch_3d", False) and kw.get("fake_3d", False):
            kw["patch_mode"] = "fake_3d"
        elif kw.get("patch_3d", False):
            kw["patch_mode"] = "3d"
    if kw.get("casual_3d_upsampler_index") is None:
        kw.pop("casual_3d_upsampler_index", None)
    else:
        kw["casual_3d_upsampler_index"] = tuple(
            kw["casual_3d_upsampler_index"])
    return {**_filter_fields(Transformer3DConfig, kw), **fields}


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
    if t_type == "HunyuanTransformer3DModel":
        cfg = HunyuanConfig(dtype=dtype, **_filter_fields(HunyuanConfig, kw))
        return HunyuanTransformer3D(cfg, device=device), cfg
    if t_type == "Transformer3DModel":
        cfg = Transformer3DConfig(dtype=dtype, **_transformer3d_fields(kw))
        return Transformer3D(cfg, device=device), cfg
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
        cfg = MagvitVAEConfig(dtype=dtype,
                              **_filter_fields(MagvitVAEConfig, kw))
        return AutoencoderKLMagvit(cfg, device=device), cfg
    if v_type == "AutoencoderKL":
        cfg = KL2DConfig(dtype=dtype, **_filter_fields(KL2DConfig, kw))
        return AutoencoderKL(cfg, device=device), cfg
    if v_type == "AutoencoderKLCogVideoX":
        raise NotImplementedError(f"vae_type {v_type!r} is not ported "
                                  "(ROADMAP queue 1 item 11.b)")
    raise ValueError(f"unknown vae_type {v_type}")
