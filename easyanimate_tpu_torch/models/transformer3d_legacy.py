"""Transformer3D: the V1-V3 editions' video denoiser (PixArt-style DiT with
temporal motion modules), and Transformer2D, its image (PixArt) form.

Parity: easyanimate_tpu/models/transformer3d_legacy.py (reference
transformer3d.py:140-818, attention.py:128-721, motion_module.py), all of
it. Forward:
  - patchify (`patch_mode`): "2d" a per-frame Conv2d (every shipped
    config), "3d" a Conv3d (time_patch_size, p, p), "casual_3d" the same
    after replicating frame 0 time_patch_size - 1 times in front (f' = (f -
    1) // tp + 1, with the mid-stack 2x linear-in-time upsampler at
    casual_3d_upsampler_index), "fake_3d" a Conv2d then a strided Conv1d
    over time (average-initialised), mirrored at the output by a 2x nearest
    repeat and a 3-tap Conv1d; then a 2D sin-cos table per frame;
  - AdaLN-single: the 256-wide timestep sinusoid through an MLP (emb), and
    SiLU + Linear(6 * dim) of it shared by every block;
  - the PixArt caption projection (Linear, tanh gelu, Linear);
  - num_layers TemporalTransformerBlocks with U-ViT long skips (pushed
    after layers i < 13, popped from i >= 15 through zero-initialised
    linears);
  - a (2, dim) scale-shift table plus emb around a float32 LayerNorm
    (eps 1e-6), proj_out, unpatchify (learned sigma: out_channels 8).
A block: AdaLN-modulated LayerNorm (eps norm_eps), per-frame spatial self
attention, the temporal branch (a MotionModule, or for
`selfattentiontemporal` attention over the frames), the text cross
attention with no norm in front of it (PixArt), the modulated GEGLU
feed-forward (exact gelu), after_norm. A MotionModule (VanillaTemporal
Module): LayerNorm (eps 1e-5), proj_in, per transformer block its
attention blocks (Temporal_Self over the frames of one position, or of a
block_size x block_size cell with `grid`; Global_Self over every token)
each with a sinusoidal position table over its sequence, a GEGLU
feed-forward, then a zero-initialised proj_out, added to its input.

Attention routing, as in JAX: every attention without a mask bias goes
through ops.attention.attention (K1 on a CUDA tensor: at head dim 72 the
TMA + wgmma kernel csrc/flash_fwd.cu::flash_fwd_d72_sm90, or for at most 64
q rows the mma.sync body; at head dim 144, V1's and V2's motion modules,
the mma.sync body; the plain version on the CPU). The text cross attention
with a text mask is JAX's dense einsum outside any kernel, and so plain
matmuls here.

Dtypes follow JAX's: the linears and convs hold the config's dtype and
cast their input to it (flax's Dense(dtype=...)); the self.param tensors
(norm affines, scale-shift tables) stay float32, so that, as in JAX, the
modulated residual stream is float32 after the first block.

Parameter names are the Flax module's paths (block{i} as blocks.{i}), so
models/convert.py::transformer3d_state_dict_from_jax carries JAX's params
across; the JAX package has no loader for a V1-V3 directory, and neither
has the port.
"""
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import attention, biased_attention, check_attn_impl
from ..ops.norms import fp32_layer_norm
from .embeddings import (TimestepEmbedding, sinusoidal_timestep_embedding,
                         unpatchify)
from .hunyuan import _f32, _heads, _merge, resize_matrix, temporal_pe
from .mmdit import sincos_2d

PATCH_MODES = ("2d", "3d", "fake_3d", "casual_3d")
BLOCK_TYPES = ("basic", "motionmodule", "global_motionmodule",
               "selfattentiontemporal")


@dataclasses.dataclass(frozen=True)
class MotionModuleConfig:
    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: Tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 4096
    block_size: int = 1
    grid: bool = False


@dataclasses.dataclass(frozen=True)
class Transformer3DConfig:
    """JAX's Transformer3DConfig: its fields and defaults (V3 at 16 x 72
    heads, 28 layers, global motion modules on the odd layers)."""
    num_attention_heads: int = 16
    attention_head_dim: int = 72
    in_channels: int = 4
    out_channels: int = 8            # learned sigma -> 2x latent channels
    patch_size: int = 2
    num_layers: int = 28
    cross_attention_dim: int = 1152
    caption_channels: int = 4096     # T5 hidden size
    norm_eps: float = 1e-6
    basic_block_type: str = "global_motionmodule"
    enable_uvit: bool = True
    qk_norm: bool = False
    after_norm: bool = False
    motion_module_even: MotionModuleConfig = dataclasses.field(
        default_factory=MotionModuleConfig)
    motion_module_odd: MotionModuleConfig = dataclasses.field(
        default_factory=lambda: MotionModuleConfig(
            attention_block_types=("Temporal_Self", "Global_Self")))
    time_position_encoding_before_transformer: bool = False
    patch_mode: str = "2d"
    time_patch_size: Optional[int] = None
    casual_3d_upsampler_index: Tuple[int, ...] = ()
    # pipeline-facing: V1-V3 use sinusoidal tables, so build_rope's 2d
    # branch output is ignored by the model
    time_position_encoding_type: str = "sinusoidal"
    vae_scale_factor: int = 8
    dtype: str = "bfloat16"
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.patch_mode not in PATCH_MODES:
            raise ValueError(f"unknown patch_mode {self.patch_mode}")
        if self.basic_block_type not in BLOCK_TYPES:
            raise ValueError(f"unknown basic_block_type "
                             f"{self.basic_block_type}")
        check_attn_impl(self.attn_impl)

    @property
    def t_patch(self) -> int:
        return self.time_patch_size or self.patch_size

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Dense(nn.Linear):
    """flax's Dense(dtype=...): the input cast to the weight's dtype."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def _zero_(module: nn.Module) -> nn.Module:
    """JAX's kernel_init=zeros (the bias is zero-initialised anyway)."""
    if module.weight.device.type != "meta":
        with torch.no_grad():
            module.weight.zero_()
            module.bias.zero_()
    return module


class _Attn(nn.Module):
    """diffusers Attention: q, k, v without bias, optional float32
    LayerNorm (eps 1e-6) on q and k, to_out with bias; self or cross
    attention, with the text mask's additive bias as plain matmuls."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 qk_norm: bool = False, **fk):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Dense(dim, inner, bias=False, **fk)
        self.to_k = Dense(dim, inner, bias=False, **fk)
        self.to_v = Dense(dim, inner, bias=False, **fk)
        self.qk_norm = qk_norm
        if qk_norm:
            dev = fk["device"]
            self.norm_q_scale = _f32(head_dim, device=dev, value=1.0)
            self.norm_q_bias = _f32(head_dim, device=dev, value=0.0)
            self.norm_k_scale = _f32(head_dim, device=dev, value=1.0)
            self.norm_k_bias = _f32(head_dim, device=dev, value=0.0)
        self.to_out = Dense(inner, dim, **fk)

    def forward(self, x, context=None, bias: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        q, k, v = (_heads(a, self.heads) for a in (
            self.to_q(x), self.to_k(ctx), self.to_v(ctx)))
        if self.qk_norm:
            q = fp32_layer_norm(q, self.norm_q_scale, self.norm_q_bias, 1e-6)
            k = fp32_layer_norm(k, self.norm_k_scale, self.norm_k_bias, 1e-6)
        o = attention(q, k, v) if bias is None else biased_attention(
            q, k, v, bias)
        return self.to_out(_merge(o))


class _FeedForwardGEGLU(nn.Module):
    """wi to 2 * mult * dim, a * gelu(g) on the exact gelu, wo back."""

    def __init__(self, dim: int, mult: int = 4, **fk):
        super().__init__()
        self.wi = Dense(dim, 2 * dim * mult, **fk)
        self.wo = Dense(dim * mult, dim, **fk)

    def forward(self, x):
        a, g = self.wi(x).chunk(2, dim=-1)
        return self.wo(a * F.gelu(g))


class MotionModule(nn.Module):
    """VanillaTemporalModule over tokens (B, f*h*w, C): norm + proj_in,
    the attention blocks with their sinusoidal tables (optionally
    grid-blocked), GEGLU feed-forwards, a zero-initialised proj_out, added
    to the input. Its LayerNorms take the default eps, 1e-5."""

    def __init__(self, dim: int, mm: MotionModuleConfig, **fk):
        super().__init__()
        self.dim, self.mm = dim, mm
        dev = fk["device"]
        self.norm_scale = _f32(dim, device=dev, value=1.0)
        self.norm_bias = _f32(dim, device=dev, value=0.0)
        self.proj_in = Dense(dim, dim, **fk)
        heads = mm.num_attention_heads
        for blk in range(mm.num_transformer_block):
            for ai, kind in enumerate(mm.attention_block_types):
                if kind not in ("Temporal_Self", "Global_Self"):
                    raise ValueError(kind)
                setattr(self, f"b{blk}_a{ai}_norm_scale",
                        _f32(dim, device=dev, value=1.0))
                setattr(self, f"b{blk}_a{ai}_norm_bias",
                        _f32(dim, device=dev, value=0.0))
                setattr(self, f"b{blk}_a{ai}_attn",
                        _Attn(dim, heads, dim // heads, **fk))
            setattr(self, f"b{blk}_ff_norm_scale",
                    _f32(dim, device=dev, value=1.0))
            setattr(self, f"b{blk}_ff_norm_bias",
                    _f32(dim, device=dev, value=0.0))
            setattr(self, f"b{blk}_ff", _FeedForwardGEGLU(dim, **fk))
        self.proj_out = _zero_(Dense(dim, dim, **fk))

    def _pe(self, n: int, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(temporal_pe(n, self.dim)).to(like.device,
                                                             like.dtype)

    def _temporal(self, yn, attn, f, h, w):
        """Temporal_Self: attention over the f frames of each position (or
        the f * bs * bs tokens of each bs x bs cell with `grid`)."""
        b, dim, bs = yn.shape[0], self.dim, self.mm.block_size
        grid = self.mm.grid and bs > 1
        g = yn.reshape(b, f, h, w, dim)
        if grid:  # (b h w) (f n m) c token groups of a bs x bs cell
            t = g.reshape(b, f, h // bs, bs, w // bs, bs, dim).permute(
                0, 2, 4, 1, 3, 5, 6).reshape(b * (h // bs) * (w // bs),
                                             f * bs * bs, dim)
        else:
            t = g.permute(0, 2, 3, 1, 4).reshape(b * h * w, f, dim)
        if self.mm.temporal_position_encoding:
            t = t + self._pe(t.shape[1], t)[None]
        o = attn(t)
        if grid:
            o = o.reshape(b, h // bs, w // bs, f, bs, bs, dim).permute(
                0, 3, 1, 4, 2, 5, 6)
        else:
            o = o.reshape(b, h, w, f, dim).permute(0, 3, 1, 2, 4)
        return o.reshape(b, f * h * w, dim)

    def _global(self, yn, attn, f, h, w):
        """Global_Self: attention over every token, the frame's sinusoid
        added to each of its tokens."""
        b, dim = yn.shape[0], self.dim
        t = yn.reshape(b, f, h * w, dim)
        if self.mm.temporal_position_encoding:
            t = t + self._pe(f, t)[None, :, None]
        return attn(t.reshape(b, f * h * w, dim))

    def forward(self, x, f: int, h: int, w: int):
        y = self.proj_in(fp32_layer_norm(x, self.norm_scale, self.norm_bias))
        for blk in range(self.mm.num_transformer_block):
            for ai, kind in enumerate(self.mm.attention_block_types):
                yn = fp32_layer_norm(y, getattr(self, f"b{blk}_a{ai}_norm_scale"),
                                     getattr(self, f"b{blk}_a{ai}_norm_bias"))
                attn = getattr(self, f"b{blk}_a{ai}_attn")
                branch = self._temporal if kind == "Temporal_Self" else self._global
                y = y + branch(yn, attn, f, h, w)
            yn = fp32_layer_norm(y, getattr(self, f"b{blk}_ff_norm_scale"),
                                 getattr(self, f"b{blk}_ff_norm_bias"))
            y = y + getattr(self, f"b{blk}_ff")(yn)
        return x + self.proj_out(y)


class TemporalTransformerBlock(nn.Module):
    """Spatial self attention -> the temporal branch -> text cross attention
    -> feed-forward, under PixArt's AdaLN-single modulation."""

    def __init__(self, cfg: Transformer3DConfig,
                 motion: Optional[MotionModuleConfig], **fk):
        super().__init__()
        self.cfg = cfg
        dim, dev = cfg.inner_dim, fk["device"]
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.scale_shift_table = _f32(6, dim, device=dev, std=dim ** -0.5)
        self.attn1 = _Attn(dim, heads, hd, cfg.qk_norm, **fk)
        # "motion": a MotionModule; "attention": attention over the frames
        # (selfattentiontemporal); None: no temporal branch (basic)
        self.temporal = None
        if motion is not None:
            self.temporal = "motion"
            self.attn_temporal = MotionModule(dim, motion, **fk)
        elif cfg.basic_block_type == "selfattentiontemporal":
            self.temporal = "attention"
            self.attn_temporal = _Attn(dim, heads, hd, cfg.qk_norm, **fk)
        self.attn2 = _Attn(dim, heads, hd, cfg.qk_norm, **fk)
        self.ff = _FeedForwardGEGLU(dim, **fk)
        if cfg.after_norm:
            self.norm4_scale = _f32(dim, device=dev, value=1.0)
            self.norm4_bias = _f32(dim, device=dev, value=0.0)

    def forward(self, x, t6, text, text_bias, f: int, h: int, w: int):
        cfg, dim, b = self.cfg, self.cfg.inner_dim, x.shape[0]
        mods = self.scale_shift_table[None] + t6.reshape(b, 6, dim)
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = (mods[:, i][:, None] for i in range(6))
        # 1. spatial self attention, per frame
        xn = (fp32_layer_norm(x, eps=cfg.norm_eps) * (1 + scale_msa)
              + shift_msa)
        o = self.attn1(xn.reshape(b * f, h * w, dim))
        x = x + gate_msa * o.reshape(b, f * h * w, dim)
        # 2. the temporal branch
        if self.temporal == "motion":
            x = self.attn_temporal(x, f, h, w)
        elif self.temporal == "attention":
            xt = x.reshape(b, f, h * w, dim).transpose(1, 2).reshape(
                b * h * w, f, dim)
            o = self.attn_temporal(xt)
            x = x + o.reshape(b, h * w, f, dim).transpose(1, 2).reshape(
                b, f * h * w, dim)
        # 3. text cross attention (PixArt: no norm in front of it)
        x = x + self.attn2(x, text, text_bias)
        # 4. feed-forward
        xn = (fp32_layer_norm(x, eps=cfg.norm_eps) * (1 + scale_mlp)
              + shift_mlp)
        ff = self.ff(xn)
        if cfg.after_norm:
            ff = fp32_layer_norm(ff, self.norm4_scale, self.norm4_bias,
                                 cfg.norm_eps)
        return x + gate_mlp * ff


def _avg_conv1d_(conv: nn.Conv1d) -> nn.Conv1d:
    """Patch1D's init (reference patch.py:83-88): each output channel the
    average of its own input channel over the taps, bias 0."""
    if conv.weight.device.type != "meta":
        with torch.no_grad():
            conv.weight.zero_()
            idx = torch.arange(conv.out_channels)
            conv.weight[idx, idx] = 1.0 / conv.kernel_size[0]
            conv.bias.zero_()
    return conv


class Transformer3D(nn.Module):
    """The V1-V3 video DiT."""

    def __init__(self, cfg: Transformer3DConfig, device=None):
        """Parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        fk = dict(device=dev, dtype=cfg.torch_dtype)
        dim, p, tp = cfg.inner_dim, cfg.patch_size, cfg.t_patch
        if cfg.patch_mode in ("2d", "fake_3d"):
            self.pos_embed_proj = nn.Conv2d(cfg.in_channels, dim, p,
                                            stride=p, **fk)
        else:
            self.pos_embed_proj = nn.Conv3d(cfg.in_channels, dim, (tp, p, p),
                                            stride=(tp, p, p), **fk)
        if cfg.patch_mode == "fake_3d":
            self.pos_embed_proj_t = _avg_conv1d_(
                nn.Conv1d(dim, dim, p, stride=p, **fk))
            self.unpatch1d_conv = nn.Conv1d(dim, dim, 3, padding=1, **fk)
        self.adaln_single_emb = TimestepEmbedding(256, dim, **fk)
        self.adaln_single_linear = Dense(dim, 6 * dim, **fk)
        self.caption_proj_1 = Dense(cfg.caption_channels, dim, **fk)
        self.caption_proj_2 = Dense(dim, dim, **fk)
        self.n_skips = max(0, cfg.num_layers - 15) if cfg.enable_uvit else 0
        for i in range(self.n_skips):
            setattr(self, f"long_connect_fc{i}", _zero_(Dense(dim, dim, **fk)))
        use_motion = cfg.basic_block_type in ("motionmodule",
                                              "global_motionmodule")
        self.blocks = nn.ModuleList([
            TemporalTransformerBlock(
                cfg, ((cfg.motion_module_even if i % 2 == 0
                       else cfg.motion_module_odd) if use_motion else None),
                **fk)
            for i in range(cfg.num_layers)])
        self.scale_shift_table = _f32(2, dim, device=dev, std=dim ** -0.5)
        out = (tp if cfg.patch_mode == "3d" else 1) * p * p * cfg.out_channels
        self.proj_out = Dense(dim, out, **fk)

    def _patchify(self, hidden_states):
        """latents (B, C, f, H, W) -> tokens (B, f' * h * w, dim) in the
        config's dtype, and f'."""
        cfg, dim, p, tp = self.cfg, self.cfg.inner_dim, self.cfg.patch_size, \
            self.cfg.t_patch
        x = hidden_states.to(cfg.torch_dtype)
        b, c, f, hh, ww = x.shape
        h, w = hh // p, ww // p
        if cfg.patch_mode in ("2d", "fake_3d"):
            y = self.pos_embed_proj(x.transpose(1, 2).reshape(b * f, c, hh, ww))
            x = y.reshape(b, f, dim, h * w).transpose(2, 3)  # (b, f, hw, dim)
            if cfg.patch_mode == "fake_3d":
                t = x.permute(0, 2, 3, 1).reshape(b * h * w, dim, f)
                t = self.pos_embed_proj_t(t)
                f = f // p
                x = t.reshape(b, h * w, dim, f).permute(0, 3, 1, 2)
        else:
            if cfg.patch_mode == "casual_3d":
                x = torch.cat([x[:, :, :1].expand(-1, -1, tp - 1, -1, -1), x],
                              dim=2)
                f = (f - 1) // tp + 1
            else:
                f = f // tp
            y = self.pos_embed_proj(x)
            x = y.flatten(3).permute(0, 2, 3, 1)  # (b, f', hw, dim)
        pos = torch.from_numpy(sincos_2d(dim, h, w)).to(x.device, x.dtype)
        return (x + pos[None, None]).reshape(b, f * h * w, dim), f

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor, rope=None,
                text_mask: Optional[torch.Tensor] = None,
                encoder_hidden_states_t5: Optional[torch.Tensor] = None,
                inpaint_latents: Optional[torch.Tensor] = None,
                control_latents: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """latents (B, C, f, H, W), timestep (B,), T5 states (B, L, 4096)
        -> prediction (B, out_channels, f, H, W). rope and the second text
        stream are taken for the pipelines' signature and unused (V1-V3
        use sinusoidal tables and one text encoder)."""
        cfg = self.cfg
        dt, dim, p = cfg.torch_dtype, cfg.inner_dim, cfg.patch_size
        extra = [a.to(hidden_states.dtype)
                 for a in (inpaint_latents, control_latents) if a is not None]
        if extra:
            hidden_states = torch.cat([hidden_states, *extra], dim=1)
        b, _, _, hh, ww = hidden_states.shape
        h, w = hh // p, ww // p
        x, f = self._patchify(hidden_states)
        emb = self.adaln_single_emb(
            sinusoidal_timestep_embedding(timestep, 256).to(dt))
        t6 = self.adaln_single_linear(F.silu(emb))
        text = self.caption_proj_2(F.gelu(
            self.caption_proj_1(encoder_hidden_states), approximate="tanh"))
        text_bias = None
        if text_mask is not None:
            text_bias = ((1.0 - text_mask.float()) * -10000.0)[:, None, :]
        skips = []
        for i, block in enumerate(self.blocks):
            if cfg.enable_uvit and i >= 15:
                x = x + getattr(self, f"long_connect_fc{i - 15}")(skips.pop())
            if (cfg.patch_mode == "casual_3d"
                    and i in cfg.casual_3d_upsampler_index):
                # TemporalUpsampler3D (patch.py:142-154): frame 0 kept, the
                # rest resized 2x in time as jax.image.resize's linear
                g = x.reshape(b, f, h * w, dim)
                mat = torch.from_numpy(resize_matrix(f - 1, 2 * (f - 1),
                                                     "bilinear")).to(x.device)
                rest = torch.einsum("ij,bjnc->binc", mat, g[:, 1:].float())
                f = (f - 1) * 2 + 1
                x = torch.cat([g[:, :1], rest.to(x.dtype)], dim=1).reshape(
                    b, f * h * w, dim)
            x = block(x, t6, text, text_bias, f, h, w)
            if cfg.enable_uvit and i < 13:
                skips.append(x)
        if cfg.patch_mode == "fake_3d":
            # UnPatch1D (patch.py:97-130): 2x nearest in time + a 3-tap conv
            g = x.reshape(b, f, h * w, dim).permute(0, 2, 3, 1).reshape(
                b * h * w, dim, f)
            g = self.unpatch1d_conv(g.repeat_interleave(2, dim=2).to(dt))
            f = 2 * f
            x = g.reshape(b, h * w, dim, f).permute(0, 3, 1, 2).reshape(
                b, f * h * w, dim)
        mods = self.scale_shift_table[None] + emb[:, None]
        shift, scale = mods[:, 0][:, None], mods[:, 1][:, None]
        x = fp32_layer_norm(x, eps=1e-6) * (1 + scale) + shift
        x = self.proj_out(x)
        if cfg.patch_mode == "3d":
            tp, c = cfg.t_patch, cfg.out_channels
            x = x.reshape(b, f, h, w, tp, p, p, c)
            x = torch.einsum("nfhwopqc->ncfohpwq", x)
            return x.reshape(b, c, f * tp, h * p, w * p)
        return unpatchify(x, f, h, w, p, cfg.out_channels)


def Transformer2D(cfg: Transformer3DConfig, device=None) -> Transformer3D:
    """PixArt's image DiT (reference transformer2d.py): this architecture
    with single-frame inputs, basic blocks and no U-ViT skips."""
    cfg = dataclasses.replace(cfg, basic_block_type="basic",
                              enable_uvit=False)
    return Transformer3D(cfg, device=device)
