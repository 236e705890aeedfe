"""Text-to-video pipeline: CFG-batched flow-matching denoise loop, then the
MagViT decode.

Parity: easyanimate_tpu/pipeline/t2v.py::EasyAnimatePipeline.__call__
(reference pipeline_easyanimate.py:769-1149): prompt embeds (+ negative) ->
CFG batch -> latents (frame remap) -> 3D RoPE from the 720x480 base grid ->
N Euler steps -> VAE decode. The loop is a Python loop over steps
(`_denoise`, which the inpaint pipeline shares). TeaCache, cfg_skip,
cfg_split and the other samplers are not ported.
"""
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.mmdit import EasyAnimateTransformer3D, MMDiTConfig
from ..models.vae.magvit import (AutoencoderKLMagvit, latent_frame_count,
                                 vae_decode, vae_decode_tiled)
from ..ops.rope import get_3d_rotary_pos_embed, get_resize_crop_region_for_grid
from .schedulers import (FlowMatchEulerConfig, flow_match_per_step,
                         flow_match_step, init_noise_sigma, rescale_noise_cfg)

Callback = Optional[Callable[[int, torch.Tensor], None]]


def build_rope(cfg: MMDiTConfig, height: int, width: int, latent_frames: int,
               vae_scale: Optional[int] = None, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D RoPE tables (cos, sin) [T*h*w, head_dim] float32 for a
    (height, width, frames) generation (pipeline_easyanimate.py:998-1019),
    on `device` (the card by default)."""
    s = (vae_scale or cfg.vae_scale_factor) * cfg.patch_size
    gh, gw = height // s, width // s
    crop = get_resize_crop_region_for_grid(
        (gh, gw), cfg.rope_base_width // s, cfg.rope_base_height // s)
    cos, sin = get_3d_rotary_pos_embed(cfg.attention_head_dim, crop, (gh, gw),
                                       latent_frames)
    device = resolve_device(device)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


class EasyAnimatePipeline:
    """T2V generation on one device: `device`, by default the one that holds
    the transformer's parameters (the card for a model built with the
    defaults)."""

    def __init__(self, transformer: EasyAnimateTransformer3D,
                 vae: AutoencoderKLMagvit, device=None,
                 scheduler: FlowMatchEulerConfig = FlowMatchEulerConfig()):
        self.transformer = transformer
        self.vae = vae
        self.device = (next(transformer.parameters()).device if device is None
                       else torch.device(device))
        self.scheduler = scheduler

    def latent_shape(self, batch: int, video_length: int, height: int,
                     width: int) -> Tuple[int, ...]:
        cfg = self.vae.cfg
        sf = cfg.spatial_compression
        return (batch, cfg.latent_channels,
                latent_frame_count(video_length, cfg), height // sf, width // sf)

    @torch.inference_mode()
    def __call__(self, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None, *,
                 height: int = 384, width: int = 672, video_length: int = 49,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 guidance_rescale: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 output_type: str = "np", callback: Callback = None):
        """prompt embeds (B, S, D) -> video (B, 3, T, H, W) as a numpy array,
        float in [0, 1] ('np') or uint8 ('uint8'), or the final latents
        ('latent'). `latents` replaces the initial noise; `generator` draws
        it otherwise. `callback(step, latents)` runs after every step."""
        _check_output_type(output_type)
        shape = self.latent_shape(prompt_embeds.shape[0], video_length,
                                  height, width)
        if latents is None:
            latents = torch.randn(shape, generator=generator,
                                  device=self.device, dtype=torch.float32)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        latents = latents.to(self.device, torch.float32)
        latents = (latents * init_noise_sigma(self.scheduler,
                                              num_inference_steps)
                   ).to(self.transformer.cfg.torch_dtype)
        latents = self._denoise(
            latents, self._cfg_text(prompt_embeds, negative_prompt_embeds,
                                    guidance_scale),
            height, width, num_inference_steps, guidance_scale,
            guidance_rescale, cond={}, t_start=0, callback=callback)
        return self._output(latents, output_type)

    def _cfg_text(self, prompt_embeds, negative_prompt_embeds,
                  guidance_scale: float) -> torch.Tensor:
        """The text batch on the device: [negative; positive] under CFG."""
        if guidance_scale <= 1.0:
            return prompt_embeds.to(self.device)
        if negative_prompt_embeds is None:
            raise ValueError("CFG (guidance_scale > 1) needs negative embeds")
        return torch.cat([negative_prompt_embeds, prompt_embeds]).to(self.device)

    def _denoise(self, latents: torch.Tensor, txt: torch.Tensor, height: int,
                 width: int, num_inference_steps: int, guidance_scale: float,
                 guidance_rescale: float, cond: Dict[str, torch.Tensor],
                 t_start: int = 0, callback: Callback = None) -> torch.Tensor:
        """The flow-match Euler loop from step t_start on (JAX _denoise_fn):
        each step runs the transformer on the CFG batch with `cond` (keyword
        arguments of the transformer, already CFG-batched), combines the
        halves and steps the latents. callback(i, latents) after each."""
        do_cfg = guidance_scale > 1.0
        latent_channels = self.vae.cfg.latent_channels
        rope = build_rope(self.transformer.cfg, height, width,
                          latents.shape[2],
                          vae_scale=self.vae.cfg.spatial_compression,
                          device=self.device)
        timesteps, sigmas = flow_match_per_step(self.scheduler,
                                                num_inference_steps, t_start)
        for i, t in enumerate(timesteps):
            lat_in = torch.cat([latents, latents]) if do_cfg else latents
            t_vec = torch.full((lat_in.shape[0],), float(t),
                               dtype=torch.float32, device=self.device)
            pred = self.transformer(lat_in, t_vec, txt, rope, **cond)
            pred = pred[:, :latent_channels]  # drop a learned-sigma half
            if do_cfg:
                uncond, text = pred.chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
                if guidance_rescale > 0:
                    pred = rescale_noise_cfg(pred, text, guidance_rescale)
            latents = flow_match_step(latents, pred, float(sigmas[i]),
                                      float(sigmas[i + 1]))
            if callback is not None:
                callback(i, latents)
        return latents

    def _output(self, latents: torch.Tensor, output_type: str):
        if output_type == "latent":
            return latents
        return self.decode_latents(latents, to_uint8=output_type == "uint8")

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor,
                       to_uint8: bool = False) -> np.ndarray:
        """latents -> video (B, C, T, H, W) numpy: float in [0, 1], or
        uint8 rounded on the device. Spatial tiling engages when the latent
        is wider or taller than tile_sample_min_size pixels."""
        cfg = self.vae.cfg
        tile_latent = cfg.tile_sample_min_size // cfg.spatial_compression
        lat = (latents.float() / cfg.scaling_factor).to(cfg.torch_dtype)
        if max(lat.shape[-2:]) > tile_latent:
            video = vae_decode_tiled(self.vae, lat)
        else:
            video = vae_decode(self.vae, lat)
        out = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
        if to_uint8:
            out = torch.round(out * 255.0).to(torch.uint8)
        return out.cpu().numpy()


def _check_output_type(output_type: str) -> None:
    if output_type not in ("np", "uint8", "latent"):
        raise ValueError(f"unknown output_type {output_type!r}")
