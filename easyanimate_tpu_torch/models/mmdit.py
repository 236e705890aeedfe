"""EasyAnimateTransformer3D: the V5/V5.1 MMDiT video denoiser.

Parity: easyanimate_tpu/models/mmdit.py (reference transformer3d.py:
1347-1689). Forward: time sinusoid (inner_dim) -> 2-layer MLP -> temb;
per-frame Conv2d patchify; text_proj; N dual-stream blocks with 3D RoPE on
the video tokens; final LayerNorm; AdaLayerNorm (shift, scale from temb);
proj_out; unpatchify. The layer stack is an nn.ModuleList run in a Python
loop; with `remat` (the JAX field, default on) and grad enabled each block
runs under torch.utils.checkpoint, so the backward recomputes it from its
inputs instead of keeping its activations. The conditioning branches
of the V5.1 models (JAX :231-269): `inpaint_latents` then `control_latents`
join the latents on the channel axis in front of the patchify (InP and
Control models); `ref_latents` go through `ref_proj` plus a 2-D sin-cos
table and replace the text tokens; `clip_encoder_hidden_states` go through
`clip_proj` and are prepended to them. V5's two prompt streams (JAX
:144-153, :250-257): the Bert stream through `text_proj` and the mT5
stream (`encoder_hidden_states_t5`) through `text_proj_t5`, each after a
float32 RMS norm (eps 1e-6) when `add_norm_text_encoder` is set, joined
as [text, t5] before the ref and clip branches.
"""
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.norms import RMSNorm, fp32_layer_norm
from .blocks import MMDiTBlock
from .embeddings import (PatchEmbed2D, TimestepEmbedding,
                         sinusoidal_timestep_embedding, unpatchify)


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    num_attention_heads: int = 48
    attention_head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    patch_size: int = 2
    num_layers: int = 48
    mmdit_layers: int = 10000  # layers >= this index share stream params
    swa_layers: Optional[Sequence[int]] = None
    time_embed_dim: int = 512
    text_embed_dim: int = 3584        # Qwen2-VL hidden size (V5.1)
    # V5: the mT5 stream's width (its text_proj_t5) and the RMS norm in
    # front of both text projections
    text_embed_dim_t5: Optional[int] = None
    add_norm_text_encoder: bool = False
    after_norm: bool = False
    norm_eps: float = 1e-5
    time_position_encoding_type: str = "3d_rope"
    qk_norm: bool = True
    # ref / clip conditioning (control models)
    ref_channels: Optional[int] = None
    clip_channels: Optional[int] = None
    add_ref_latent_in_control_model: bool = False
    # inpaint models: the mask goes in as one channel resized to the latent
    # grid (else as VAE-encoded latents), and the reference video may be
    # noise-augmented (read by pipeline/inpaint.py)
    resize_inpaint_mask_directly: bool = True
    add_noise_in_inpaint_model: bool = True
    # recompute each block in the backward (easyanimate_tpu mmdit.py:166-170)
    remat: bool = True
    dtype: str = "bfloat16"
    # quantized block linears (ops/quant.py): None, "int8" (W8A8), "int4"
    # (W4A16) or "w4a8"; set by loader.load_pipeline, as JAX's
    # (easyanimate_tpu/models/mmdit.py:68-70)
    linear_quant: Optional[str] = None
    # RoPE base grid (pipeline_easyanimate.py:1002-1006)
    rope_base_height: int = 480
    rope_base_width: int = 720
    vae_scale_factor: int = 8

    def __post_init__(self):
        if self.time_position_encoding_type != "3d_rope":
            raise NotImplementedError(
                f"time_position_encoding_type "
                f"{self.time_position_encoding_type!r}: only '3d_rope' is "
                "ported (the legacy editions: ROADMAP queue 1 item 11)")

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


PRESETS: Dict[str, MMDiTConfig] = {
    # flagship: ~11.8B dual-stream parameters (marketed "12B")
    "v5.1-12b": MMDiTConfig(),
    # image/video-to-video: latents + 1 mask channel + 16 masked-video latents
    "v5.1-12b-inpaint": MMDiTConfig(in_channels=16 + 1 + 16),
    "v5.1-7b": MMDiTConfig(num_attention_heads=40, num_layers=40),
    # V5 (EasyAnimateV5-12b-zh): the 12B with the Bert (1024) + mT5-XL
    # (2048) prompt streams, config/easyanimate_video_v5_magvit_multi_
    # text_encoder.yaml:3-8
    "v5-12b": MMDiTConfig(text_embed_dim=1024, text_embed_dim_t5=2048,
                          add_norm_text_encoder=True, after_norm=True),
    # tiny config for tests
    "tiny": MMDiTConfig(
        num_attention_heads=2, attention_head_dim=16, in_channels=4,
        out_channels=4, num_layers=2, time_embed_dim=32, text_embed_dim=24,
        dtype="float32"),
}


class AdaLayerNormOut(nn.Module):
    """Final AdaLayerNorm: LayerNorm, then x * (1 + scale) + shift with
    (shift, scale) = linear(silu(temb))."""

    def __init__(self, dim: int, time_dim: int, eps: float, **fk):
        super().__init__()
        self.eps = eps
        self.linear = nn.Linear(time_dim, 2 * dim, **fk)
        self.norm = nn.LayerNorm(dim, eps=eps, **fk)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, dim=-1)
        x = fp32_layer_norm(x, self.norm.weight, self.norm.bias, self.eps)
        return x * (1 + scale[:, None]) + shift[:, None]


def _text_proj(cfg: MMDiTConfig, in_dim: int, **fk) -> nn.Module:
    """A text stream's projection: a Linear, or with add_norm_text_encoder
    Sequential(RMS norm at JAX's eps 1e-6, Linear), the reference's
    text_proj.0 / .1 keys."""
    linear = nn.Linear(in_dim, cfg.inner_dim, **fk)
    if not cfg.add_norm_text_encoder:
        return linear
    return nn.Sequential(RMSNorm(in_dim, **fk), linear)


class EasyAnimateTransformer3D(nn.Module):
    def __init__(self, cfg: MMDiTConfig, device=None):
        """Parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=cfg.torch_dtype)
        dim = cfg.inner_dim
        self.time_embedding = TimestepEmbedding(dim, cfg.time_embed_dim, **fk)
        self.proj = PatchEmbed2D(cfg.in_channels, dim, cfg.patch_size, **fk)
        self.text_proj = _text_proj(cfg, cfg.text_embed_dim, **fk)
        if cfg.text_embed_dim_t5 is not None:
            self.text_proj_t5 = _text_proj(cfg, cfg.text_embed_dim_t5, **fk)
        if cfg.ref_channels is not None or cfg.add_ref_latent_in_control_model:
            # the channel count of JAX loader.py:_strict_check
            self.ref_proj = PatchEmbed2D(cfg.ref_channels or cfg.out_channels,
                                         dim, cfg.patch_size, **fk)
        if cfg.clip_channels is not None:
            self.clip_proj = nn.Linear(cfg.clip_channels, dim, **fk)
        swa = set(cfg.swa_layers or ())
        self.transformer_blocks = nn.ModuleList([
            MMDiTBlock(dim, cfg.time_embed_dim, cfg.num_attention_heads,
                       cfg.attention_head_dim, qk_norm=cfg.qk_norm,
                       after_norm=cfg.after_norm,
                       is_mmdit=i < cfg.mmdit_layers, is_swa=i in swa,
                       norm_eps=cfg.norm_eps, linear_quant=cfg.linear_quant,
                       **fk)
            for i in range(cfg.num_layers)])
        self.norm_final = nn.LayerNorm(dim, eps=cfg.norm_eps, **fk)
        self.norm_out = AdaLayerNormOut(dim, cfg.time_embed_dim, cfg.norm_eps,
                                        **fk)
        self.proj_out = nn.Linear(
            dim, cfg.patch_size * cfg.patch_size * cfg.out_channels, **fk)

    def embed(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
              encoder_hidden_states: torch.Tensor,
              inpaint_latents: Optional[torch.Tensor] = None,
              ref_latents: Optional[torch.Tensor] = None,
              clip_encoder_hidden_states: Optional[torch.Tensor] = None,
              control_latents: Optional[torch.Tensor] = None,
              encoder_hidden_states_t5: Optional[torch.Tensor] = None):
        """-> (vid_tokens, txt_tokens, temb). inpaint_latents, then
        control_latents, (B, *, T, H, W) join the latents on the channel
        axis before the patchify; V5's encoder_hidden_states_t5
        (B, S_t5, D_t5) join the text tokens after them; ref_latents
        (B, C_ref, 1, H, W) replace the text tokens; clip_encoder_hidden_
        states (B, S, C_clip) are prepended to them."""
        cfg, dt = self.cfg, self.cfg.torch_dtype
        temb = sinusoidal_timestep_embedding(timestep, cfg.inner_dim)
        temb = self.time_embedding(temb.to(dt))
        extra = [x.to(dt) for x in (inpaint_latents, control_latents)
                 if x is not None]
        if extra:
            hidden_states = torch.cat([hidden_states.to(dt), *extra], dim=1)
        vid = self.proj(hidden_states.to(dt))
        txt = self.text_proj(encoder_hidden_states.to(dt))
        if encoder_hidden_states_t5 is not None:
            if cfg.text_embed_dim_t5 is None:
                raise ValueError("encoder_hidden_states_t5 given to a model "
                                 "without a T5 stream (text_embed_dim_t5)")
            t5 = self.text_proj_t5(encoder_hidden_states_t5.to(dt))
            txt = torch.cat([txt, t5], dim=1)
        if ref_latents is not None:
            rh, rw = (s // cfg.patch_size for s in ref_latents.shape[-2:])
            pos = torch.from_numpy(sincos_2d(cfg.inner_dim, rh, rw))
            txt = self.ref_proj(ref_latents.to(dt)) + pos.to(vid.device, dt)
        if clip_encoder_hidden_states is not None:
            clip = self.clip_proj(clip_encoder_hidden_states.to(dt))
            txt = torch.cat([clip, txt], dim=1)
        return vid, txt, temb

    def backbone(self, vid, txt, temb, rope=None,
                 grid_size: Optional[Tuple[int, int, int]] = None):
        """Block stack + final norms + AdaLN-out -> video tokens."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            if remat:
                vid, txt = checkpoint(block, vid, txt, temb, rope, grid_size,
                                      use_reentrant=False)
            else:
                vid, txt = block(vid, txt, temb, rope, grid_size)
        # the reference norms concat(text, video) and keeps the video slice;
        # LayerNorm is per token, so norming the video tokens alone is equal
        vid = fp32_layer_norm(vid, self.norm_final.weight,
                              self.norm_final.bias, self.cfg.norm_eps)
        return self.norm_out(vid, temb)

    def shard_tokens(self, vid, rope=None):
        """Under a sequence-parallel scope (parallel/context.py): this sp
        rank's contiguous slice of the video tokens [B, S, dim] and of the
        RoPE rows (JAX's sp_constraint marks, blocks.py:225-228); the
        text, timestep and latents stay whole on every rank. Without a
        scope: (vid, rope)."""
        from ..parallel.context import sp_constraint

        if rope is not None:
            rope = tuple(sp_constraint(r, ("sp", None)) for r in rope)
        return sp_constraint(vid, ("dp", "sp", None)), rope

    def head(self, vid_tokens, t: int, h: int, w: int):
        """proj_out + unpatchify; (t, h, w) are latent-grid sizes. Under a
        sequence-parallel scope proj_out runs on the rank's tokens and
        every rank's are gathered before the unpatchify (JAX
        mmdit.py:226-228), so it, the sampler step and the loss run whole
        on every rank."""
        from ..parallel.context import gather_tokens

        p = self.cfg.patch_size
        return unpatchify(gather_tokens(self.proj_out(vid_tokens), 1), t,
                          h // p, w // p, p, self.cfg.out_channels)

    def modulated_input(self, vid, txt, temb):
        """Block 0's norm1 AdaLN modulation of the video stream, the
        TeaCache skip signal (reference transformer3d.py:1563-1590)."""
        norm1 = self.transformer_blocks[0].norm1
        shift, scale = norm1.linear(F.silu(temb)).chunk(6, dim=-1)[:2]
        normed = fp32_layer_norm(vid, norm1.norm.weight, norm1.norm.bias,
                                 norm1.eps)
        return normed * (1 + scale[:, None]) + shift[:, None]

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                inpaint_latents: Optional[torch.Tensor] = None,
                ref_latents: Optional[torch.Tensor] = None,
                clip_encoder_hidden_states: Optional[torch.Tensor] = None,
                control_latents: Optional[torch.Tensor] = None,
                encoder_hidden_states_t5: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """latents (B, C, T, H, W), timestep (B,), text (B, S, D_text) ->
        prediction (B, C_out, T, H, W); the conditioning inputs and V5's
        second text stream are embed's."""
        _, _, t, hh, ww = hidden_states.shape
        p = self.cfg.patch_size
        vid, txt, temb = self.embed(hidden_states, timestep,
                                    encoder_hidden_states, inpaint_latents,
                                    ref_latents, clip_encoder_hidden_states,
                                    control_latents, encoder_hidden_states_t5)
        vid, rope = self.shard_tokens(vid, rope)
        vid = self.backbone(vid, txt, temb, rope,
                            grid_size=(t, hh // p, ww // p))
        return self.head(vid, t, hh, ww)


def sincos_2d(dim: int, h: int, w: int) -> np.ndarray:
    """(h * w, dim) float32 2-D sin-cos position table (diffusers
    get_2d_sincos_pos_embed; JAX mmdit.py:_sincos_2d): the first half of the
    channels encodes the row, the second the column."""

    def one_axis(d, pos):
        omega = 1.0 / (10000.0 ** (np.arange(d // 2, dtype=np.float64)
                                   / (d / 2.0)))
        out = np.einsum("m,d->md", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, -1)
    return np.concatenate([one_axis(dim // 2, grid[1]),
                           one_axis(dim // 2, grid[0])],
                          axis=1).astype(np.float32)
