"""HunyuanTransformer3D: the V4 edition's video denoiser (EasyAnimateV4).

Parity: easyanimate_tpu/models/hunyuan.py (reference transformer3d.py:
820-1345, attention.py:733-1025, processor.py:10-216), all of it but the
`hybrid_attention` blocks' Mamba2 branch. Forward:
  - conditioning (HunyuanCombinedEmbedding): the timestep's 256-wide
    sinusoid through an MLP, plus an MLP over [the attention-pooled T5
    states, the image-size sinusoids, the style embedding];
  - two prompt streams: the Bert states as they are and the T5 states
    through a SiLU MLP, concatenated, a learned padding table where both
    masks are given and 0;
  - for I2V the CLIP-image branch: a perceiver Resampler turns the CLIP
    patch states into n_query tokens (a learned table where
    clip_attention_mask is 0), which each block's gated cross attention
    reads;
  - a per-frame Conv2d patchify; an encoder half and a decoder half of
    HunyuanDiTBlocks with long skips (pushed after layers < half - 1,
    popped in layers > half: cat, float32 LayerNorm, linear);
  - AdaLayerNormContinuous out, proj_out, unpatchify (learned sigma: twice
    the input channels out).
A block: the optional temporal sinusoid, AdaLayerNormShift, self
attention with per-head float32 LayerNorm on q and k and the 2D RoPE
tiled over the frames (none in layer 0), the text cross attention (RoPE
on q only), the gated CLIP branch (GEGLU on the exact gelu), the FFN on
the tanh gelu, after_norm. `kvcompression_basic` compresses the decoder
half's self-attention k and v with a depthwise 2x2 stride-2 conv and
resizes k's RoPE tables bilinearly.

Attention routing, as in JAX: attn1, attn2 and attn_clip go through
ops.attention.attention (K1 on a CUDA tensor, at head dim 88 the TMA +
wgmma kernel csrc/flash_fwd.cu::flash_fwd_d88_sm90; its plain version on
the CPU); AttentionPool and the Resampler run the plain attention, as
JAX's impl="xla" does.

Parameter names are the Flax module's paths (block{i} as blocks.{i}), so
models/convert.py::hunyuan_state_dict_from_jax carries JAX's params across;
the JAX package has no loader for a V4 directory, and neither has the port.
The parameters JAX creates as float32 (norm affines, the padding and style
tables, the pools' position tables, the Resampler's queries) stay float32
here; the linears and convs take the config's dtype.
"""
import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.attention import attention, biased_attention, check_attn_impl
from ..ops.norms import fp32_layer_norm
from ..ops.rope import apply_rotary_emb
from .embeddings import (PatchEmbed2D, TimestepEmbedding,
                         sinusoidal_timestep_embedding, unpatchify)
from .mmdit import sincos_2d

Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class HunyuanConfig:
    """JAX's HunyuanConfig: its fields and defaults (V4 at 16 x 88 heads,
    40 layers; the yaml adds time_position_encoding)."""
    num_attention_heads: int = 16
    attention_head_dim: int = 88
    in_channels: int = 4
    out_channels: Optional[int] = None   # None -> learn_sigma doubles
    patch_size: int = 2
    num_layers: int = 40
    mlp_ratio: float = 4.0
    learn_sigma: bool = True
    cross_attention_dim: int = 1024
    cross_attention_dim_t5: int = 2048
    pooled_projection_dim: int = 1024
    text_len: int = 77
    text_len_t5: int = 256
    basic_block_type: str = "basic"  # 'basic'|'kvcompression_basic'|'hybrid_attention'
    enable_clip_in_inpaint: bool = True
    n_query: int = 16
    projection_dim: int = 768
    # pipeline-facing flags (config/easyanimate_video_v4_*.yaml): the
    # inpaint mask is VAE-encoded, the reference video not noise-augmented
    resize_inpaint_mask_directly: bool = False
    add_noise_in_inpaint_model: bool = False
    time_position_encoding_type: str = "2d_rope"
    vae_scale_factor: int = 8
    enable_mamba: bool = True
    mamba_d_model: int = 1536
    time_position_encoding: bool = False
    after_norm: bool = False
    qk_norm: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    attn_impl: str = "auto"

    def __post_init__(self):
        if self.basic_block_type == "hybrid_attention":
            raise NotImplementedError(
                "basic_block_type 'hybrid_attention' (the Mamba2 SSD branch, "
                "ops/ssd.py) is not ported (ROADMAP queue 1 item 11.b)")
        if self.basic_block_type not in ("basic", "kvcompression_basic"):
            raise NotImplementedError(self.basic_block_type)
        check_attn_impl(self.attn_impl)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def effective_out_channels(self) -> int:
        if self.out_channels is not None:
            return self.out_channels
        return self.in_channels * 2 if self.learn_sigma else self.in_channels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def _f32(*shape, device, value: Optional[float] = None,
         std: Optional[float] = None) -> nn.Parameter:
    """A float32 parameter (JAX's self.param(..., jnp.float32) tensors),
    filled with `value`, or drawn from N(0, std^2) as JAX initialises it."""
    t = torch.empty(*shape, device=device, dtype=torch.float32)
    if t.device.type != "meta":
        if value is not None:
            t.fill_(value)
        else:
            t.normal_(0.0, std)
    return nn.Parameter(t)


def _linear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Keys' cubic with a = -0.5, jax.image's "bicubic" (torch's
    interpolate uses a = -0.75)."""
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


@functools.lru_cache(maxsize=32)
def resize_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[out_size, in_size] float32 weights of jax.image.resize along one
    axis (jax.image.scale_and_translate's compute_weight_mat, translation 0):
    kernel taps at (i + 0.5) * in / out - 0.5, widened by in / out when
    downsampling with antialias (the bicubic call's default; the bilinear
    call turns it off), normalised by their sum, so taps past an edge drop
    out instead of clamping; zero for a sample outside the input."""
    kernel, antialias = {"bilinear": (_linear_kernel, False),
                         "bicubic": (_keys_cubic_kernel, True)}[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None])
    w = kernel(x / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0.0).T.astype(np.float32)


def resize_2d(x: torch.Tensor, out_hw: Tuple[int, int],
              method: str) -> torch.Tensor:
    """jax.image.resize of x [..., h, w, c] to out_hw along h and w."""
    h, w = x.shape[-3:-1]
    if (h, w) == tuple(out_hw):
        return x
    mh, mw = (torch.from_numpy(resize_matrix(n, m, method)).to(x.device)
              for n, m in ((h, out_hw[0]), (w, out_hw[1])))
    x = torch.einsum("ih,...hwc->...iwc", mh, x.float())
    return torch.einsum("jw,...iwc->...ijc", mw, x)


def temporal_pe(length: int, dim: int) -> np.ndarray:
    """[length, dim] sinusoidal table over the frames (sin at even
    features, cos at odd), JAX _temporal_pe."""
    pos = np.arange(length)[:, None]
    div = np.exp(np.arange(0, dim, 2) * (-math.log(10000.0) / dim))
    pe = np.zeros((length, dim), np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def _heads(a: torch.Tensor, n: int) -> torch.Tensor:
    """[B, S, n * d] -> [B, n, S, d]."""
    return a.unflatten(-1, (n, -1)).transpose(1, 2)


def _merge(o: torch.Tensor) -> torch.Tensor:
    """[B, n, S, d] -> [B, S, n * d]."""
    return o.transpose(1, 2).flatten(2)


class AttentionPool(nn.Module):
    """CLIP-style attention pooling of the T5 states (embeddings.py:14-43):
    their mean as the one query over [mean, states] plus a position table
    of text_len_t5 + 1 rows (JAX sizes it from the states it is first
    called on; the port from the config, and raises on another length)."""

    def __init__(self, seq_len: int, embed_dim: int, output_dim: int,
                 num_heads: int = 8, **fk):
        super().__init__()
        self.seq_len, self.num_heads = seq_len, num_heads
        self.positional_embedding = _f32(seq_len + 1, embed_dim,
                                         device=fk["device"],
                                         std=embed_dim ** -0.5)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.k_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.v_proj = nn.Linear(embed_dim, embed_dim, **fk)
        self.c_proj = nn.Linear(embed_dim, output_dim, **fk)

    def forward(self, x):  # (B, S, C)
        if x.shape[1] != self.seq_len:
            raise ValueError(f"AttentionPool: T5 length {x.shape[1]}, but its "
                             f"position table is sized for text_len_t5 "
                             f"{self.seq_len} (+1)")
        x = torch.cat([x.mean(dim=1, keepdim=True), x], dim=1)
        x = x + self.positional_embedding[None].to(x.dtype)
        n = self.num_heads
        o = attention(_heads(self.q_proj(x[:, :1]), n),
                      _heads(self.k_proj(x), n), _heads(self.v_proj(x), n),
                      impl="plain")
        return self.c_proj(_merge(o))[:, 0]


class HunyuanCombinedEmbedding(nn.Module):
    """timestep + pooled T5 text + image size + style -> the conditioning
    vector (HunyuanCombinedTimestepTextSizeStyleEmbedding)."""

    def __init__(self, cfg: HunyuanConfig, **fk):
        super().__init__()
        hidden = cfg.inner_dim
        self.timestep_embedder = TimestepEmbedding(256, hidden, **fk)
        self.pooler = AttentionPool(cfg.text_len_t5, cfg.cross_attention_dim_t5,
                                    cfg.pooled_projection_dim, **fk)
        self.style_embedder = _f32(1, 256, device=fk["device"], std=0.02)
        extra = cfg.pooled_projection_dim + 6 * 256 + 256
        self.extra_linear_1 = nn.Linear(extra, hidden * 4, **fk)
        self.extra_linear_2 = nn.Linear(hidden * 4, hidden, **fk)

    def forward(self, timestep, t5_states, image_meta_size=None, style=None):
        dt = self.extra_linear_1.weight.dtype
        temb = self.timestep_embedder(
            sinusoidal_timestep_embedding(timestep, 256).to(dt))
        pooled = self.pooler(t5_states.to(dt))
        b = timestep.shape[0]
        if image_meta_size is None:  # the pipelines pass neither
            image_meta_size = torch.zeros((b, 6), device=timestep.device)
        size_emb = sinusoidal_timestep_embedding(
            image_meta_size.reshape(-1), 256).reshape(b, 6 * 256)
        if style is None:
            style = torch.zeros((b,), dtype=torch.long, device=timestep.device)
        extra = torch.cat([pooled.float(), size_emb,
                           self.style_embedder[style]], dim=-1)
        h = F.silu(self.extra_linear_1(extra.to(dt)))
        return temb + self.extra_linear_2(h)


class HunyuanAttention(nn.Module):
    """q, k, v projections, per-head float32 LayerNorm (eps 1e-6) on q and
    k, RoPE on q (and on k in self attention), attention, to_out
    (processor.py:10-103). With kv_compression (self attention in the
    decoder half of kvcompression_basic) k and v pass a depthwise 2x2
    stride-2 conv per frame and k's RoPE tables are resized bilinearly
    (processor.py:105-216)."""

    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_dim: Optional[int] = None, kv_compression: bool = False,
                 **fk):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        ctx = dim if cross_dim is None else cross_dim
        self.to_q = nn.Linear(dim, inner, **fk)
        self.to_k = nn.Linear(ctx, inner, **fk)
        self.to_v = nn.Linear(ctx, inner, **fk)
        self.kv_compression = kv_compression
        if kv_compression:
            self.k_compression = nn.Conv2d(inner, inner, 2, stride=2,
                                           groups=inner, **fk)
            self.v_compression = nn.Conv2d(inner, inner, 2, stride=2,
                                           groups=inner, **fk)
        dev = fk["device"]
        self.norm_q_scale = _f32(head_dim, device=dev, value=1.0)
        self.norm_q_bias = _f32(head_dim, device=dev, value=0.0)
        self.norm_k_scale = _f32(head_dim, device=dev, value=1.0)
        self.norm_k_bias = _f32(head_dim, device=dev, value=0.0)
        self.to_out = nn.Linear(inner, inner, **fk)

    def _compress(self, conv: nn.Conv2d, a: torch.Tensor, grid) -> torch.Tensor:
        f, gh, gw = grid
        b, _, c = a.shape
        y = conv(a.reshape(b * f, gh, gw, c).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(b, -1, c)

    def forward(self, x, context=None, rope: Rope = None, grid=None,
                bias: Optional[torch.Tensor] = None):
        is_cross = context is not None
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        k_rope = rope
        if self.kv_compression and not is_cross and grid is not None:
            k = self._compress(self.k_compression, k, grid)
            v = self._compress(self.v_compression, v, grid)
            if rope is not None:
                f, gh, gw = grid

                def rs(t):
                    t = t.reshape(f, gh, gw, -1)
                    return resize_2d(t, (gh // 2, gw // 2), "bilinear"
                                     ).reshape(f * (gh // 2) * (gw // 2), -1)

                k_rope = (rs(rope[0]), rs(rope[1]))
        q, k, v = (_heads(a, self.heads) for a in (q, k, v))
        q = fp32_layer_norm(q, self.norm_q_scale, self.norm_q_bias, 1e-6)
        k = fp32_layer_norm(k, self.norm_k_scale, self.norm_k_bias, 1e-6)
        if rope is not None:
            q = apply_rotary_emb(q, *rope)
            if not is_cross:
                k = apply_rotary_emb(k, *k_rope)
        if bias is not None:
            o = biased_attention(q, k, v, bias)
        else:
            o = attention(q, k, v)
        return self.to_out(_merge(o))


class Resampler(nn.Module):
    """Perceiver resampler (resampler.py:83-146): grid_size ** 2 learned
    queries cross-attend once into the image tokens; 2D sin-cos position
    tables on q and, resized bicubically as jax.image.resize does
    (resampler.py:15-31), on kv. The CLIP width must be embed_dim (V4's
    CLIP ViT-L states are 1,024 wide, its cross_attention_dim), so there is
    no kv_proj."""

    def __init__(self, grid_size: int, embed_dim: int, num_heads: int, **fk):
        super().__init__()
        self.grid_size, self.embed_dim, self.num_heads = (grid_size, embed_dim,
                                                          num_heads)
        self.query = _f32(grid_size ** 2, embed_dim, device=fk["device"],
                          std=0.02)
        f32 = dict(device=fk["device"], dtype=torch.float32)
        self.ln_q = nn.LayerNorm(embed_dim, eps=1e-5, **f32)
        self.ln_kv = nn.LayerNorm(embed_dim, eps=1e-5, **f32)
        self.q_in = nn.Linear(embed_dim, embed_dim, **fk)
        self.k_in = nn.Linear(embed_dim, embed_dim, **fk)
        self.v_in = nn.Linear(embed_dim, embed_dim, **fk)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **fk)

    def position_tables(self, n: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """(q's [grid^2, dim], kv's [n, dim]) float32 tables, built on the
        host: kv's is q's resized bicubically to sqrt(n) x sqrt(n)."""
        g, dim = self.grid_size, self.embed_dim
        src = int(round(math.sqrt(n)))
        if src * src != n:
            raise ValueError(f"Resampler kv length {n} is not square")
        q_pos = sincos_2d(dim, g, g)
        kv_pos = q_pos
        if src != g:
            mat = resize_matrix(g, src, "bicubic").astype(np.float64)
            table = q_pos.reshape(g, g, dim).astype(np.float64)
            kv_pos = np.einsum("ih,jw,hwc->ijc", mat, mat, table).reshape(n, dim)
        return (torch.from_numpy(q_pos).to(device),
                torch.from_numpy(np.asarray(kv_pos, np.float32)).to(device))

    def forward(self, x):  # (B, N, kv_dim), N a perfect square
        b, n, kv_dim = x.shape
        if kv_dim != self.embed_dim:
            raise ValueError(f"Resampler: CLIP width {kv_dim} != embed_dim "
                             f"{self.embed_dim} (no kv_proj is ported)")
        dt = self.q_in.weight.dtype
        q_pos, kv_pos = self.position_tables(n, x.device)
        q = self.ln_q(self.query)[None] + q_pos[None]
        kv = self.ln_kv(x.float())
        k, v = kv + kv_pos[None], kv
        nh, nq = self.num_heads, self.grid_size ** 2
        qh = _heads(self.q_in(q.to(dt)).expand(b, nq, -1), nh)
        o = attention(qh, _heads(self.k_in(k.to(dt)), nh),
                      _heads(self.v_in(v.to(dt)), nh), impl="plain")
        return self.out_proj(_merge(o))


class HunyuanDiTBlock(nn.Module):
    def __init__(self, cfg: HunyuanConfig, skip: bool = False,
                 kv_compression: bool = False, **fk):
        super().__init__()
        self.cfg = cfg
        dim, dev = cfg.inner_dim, fk["device"]
        heads, hd = cfg.num_attention_heads, cfg.attention_head_dim
        self.skip = skip
        if skip:
            self.skip_norm_scale = _f32(2 * dim, device=dev, value=1.0)
            self.skip_norm_bias = _f32(2 * dim, device=dev, value=0.0)
            self.skip_linear = nn.Linear(2 * dim, dim, **fk)
        self.norm1_linear = nn.Linear(dim, dim, **fk)
        self.norm1_scale = _f32(dim, device=dev, value=1.0)
        self.norm1_bias = _f32(dim, device=dev, value=0.0)
        self.attn1 = HunyuanAttention(dim, heads, hd,
                                      kv_compression=kv_compression, **fk)
        self.attn2 = HunyuanAttention(dim, heads, hd,
                                      cross_dim=cfg.cross_attention_dim, **fk)
        if cfg.enable_clip_in_inpaint:
            self.norm_clip_scale = _f32(dim, device=dev, value=1.0)
            self.norm_clip_bias = _f32(dim, device=dev, value=0.0)
            self.attn_clip = HunyuanAttention(
                dim, heads, hd, cross_dim=cfg.cross_attention_dim, **fk)
            self.gate_clip = nn.Linear(dim, 2 * dim, **fk)
            self.norm_clip_out_scale = _f32(dim, device=dev, value=1.0)
            self.norm_clip_out_bias = _f32(dim, device=dev, value=0.0)
        self.norm3_scale = _f32(dim, device=dev, value=1.0)
        self.norm3_bias = _f32(dim, device=dev, value=0.0)
        self.ff_wi = nn.Linear(dim, int(dim * cfg.mlp_ratio), **fk)
        self.ff_wo = nn.Linear(int(dim * cfg.mlp_ratio), dim, **fk)
        if cfg.after_norm:
            self.norm4_scale = _f32(dim, device=dev, value=1.0)
            self.norm4_bias = _f32(dim, device=dev, value=0.0)

    def forward(self, x, text, temb, rope: Rope, skip_states=None, grid=None,
                text_bias=None, disable_rope_in_attn1: bool = False,
                clip_context=None):
        cfg, eps = self.cfg, self.cfg.norm_eps
        f, gh, gw = grid
        if self.skip:
            cat = torch.cat([x, skip_states], dim=-1)
            x = self.skip_linear(fp32_layer_norm(
                cat, self.skip_norm_scale, self.skip_norm_bias, eps))
        if cfg.time_position_encoding and f != 1:
            pe = torch.from_numpy(temporal_pe(f, x.shape[-1])).to(x.device,
                                                                  x.dtype)
            x = (x.unflatten(1, (f, gh * gw)) + pe[None, :, None]).flatten(1, 2)
        # AdaLayerNormShift (norm.py:115-133)
        shift = self.norm1_linear(F.silu(temb.float()).to(temb.dtype))
        xn = fp32_layer_norm(x, self.norm1_scale, self.norm1_bias,
                             eps) + shift[:, None]
        rope_full = None
        if rope is not None:  # single-frame 2D tables, tiled over frames
            rope_full = (rope[0].repeat(f, 1), rope[1].repeat(f, 1))
        x = x + self.attn1(xn, rope=None if disable_rope_in_attn1
                           else rope_full, grid=grid)
        x = x + self.attn2(x, context=text, rope=rope_full, grid=grid,
                           bias=text_bias)
        if clip_context is not None:  # gated CLIP cross attention
            a = self.attn_clip(fp32_layer_norm(x, self.norm_clip_scale,
                                               self.norm_clip_bias, eps),
                               context=clip_context, rope=rope_full, grid=grid)
            val, gate = self.gate_clip(a).chunk(2, dim=-1)
            x = x + fp32_layer_norm(val * F.gelu(gate), self.norm_clip_out_scale,
                                    self.norm_clip_out_bias, eps)
        xn = fp32_layer_norm(x, self.norm3_scale, self.norm3_bias, eps)
        ff = self.ff_wo(F.gelu(self.ff_wi(xn), approximate="tanh"))
        if cfg.after_norm:
            ff = fp32_layer_norm(ff, self.norm4_scale, self.norm4_bias, eps)
        return x + ff


class HunyuanTransformer3D(nn.Module):
    def __init__(self, cfg: HunyuanConfig, device=None):
        """Parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        fk = dict(device=dev, dtype=cfg.torch_dtype)
        dim, half = cfg.inner_dim, cfg.num_layers // 2
        self.pos_embed_proj = PatchEmbed2D(cfg.in_channels, dim,
                                           cfg.patch_size, **fk)
        self.time_extra_emb = HunyuanCombinedEmbedding(cfg, **fk)
        self.text_embedder_1 = nn.Linear(cfg.cross_attention_dim_t5,
                                         cfg.cross_attention_dim_t5 * 4, **fk)
        self.text_embedder_2 = nn.Linear(cfg.cross_attention_dim_t5 * 4,
                                         cfg.cross_attention_dim, **fk)
        self.text_embedding_padding = _f32(cfg.text_len + cfg.text_len_t5,
                                           cfg.cross_attention_dim, device=dev,
                                           std=1.0)
        if cfg.enable_clip_in_inpaint:
            self.clip_projection = Resampler(
                int(round(math.sqrt(cfg.n_query))), cfg.cross_attention_dim,
                cfg.num_attention_heads, **fk)
            self.clip_padding = _f32(cfg.n_query, cfg.cross_attention_dim,
                                     device=dev, std=0.02)
        self.blocks = nn.ModuleList([
            HunyuanDiTBlock(cfg, skip=layer > half,
                            kv_compression=(cfg.basic_block_type
                                            == "kvcompression_basic"
                                            and layer >= half), **fk)
            for layer in range(cfg.num_layers)])
        self.norm_out_linear = nn.Linear(dim, 2 * dim, **fk)
        self.proj_out = nn.Linear(
            dim, cfg.patch_size ** 2 * cfg.effective_out_channels, **fk)

    def forward(self, hidden_states: torch.Tensor, timestep: torch.Tensor,
                encoder_hidden_states: torch.Tensor, rope: Rope = None,
                encoder_hidden_states_t5: Optional[torch.Tensor] = None,
                text_embedding_mask: Optional[torch.Tensor] = None,
                text_embedding_mask_t5: Optional[torch.Tensor] = None,
                image_meta_size: Optional[torch.Tensor] = None,
                style: Optional[torch.Tensor] = None,
                inpaint_latents: Optional[torch.Tensor] = None,
                control_latents: Optional[torch.Tensor] = None,
                clip_encoder_hidden_states: Optional[torch.Tensor] = None,
                clip_attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """latents (B, C, T, H, W), timestep (B,), Bert states (B, 77,
        1024), rope (cos, sin) single-frame [h*w, head_dim] tables, mT5
        states (B, 256, 2048) -> prediction (B, C_out, T, H, W)."""
        cfg = self.cfg
        dt = cfg.torch_dtype
        if encoder_hidden_states_t5 is None:
            raise ValueError("HunyuanTransformer3D needs encoder_hidden_"
                             "states_t5 (its pooled T5 conditioning)")
        extra = [a.to(dt) for a in (inpaint_latents, control_latents)
                 if a is not None]
        if extra:
            hidden_states = torch.cat([hidden_states.to(dt), *extra], dim=1)
        _, _, f, hh, ww = hidden_states.shape
        p = cfg.patch_size
        grid = (f, hh // p, ww // p)
        x = self.pos_embed_proj(hidden_states.to(dt))
        temb = self.time_extra_emb(timestep, encoder_hidden_states_t5,
                                   image_meta_size, style)
        h5 = F.silu(self.text_embedder_1(encoder_hidden_states_t5.to(dt))
                    .float()).to(dt)
        text = torch.cat([encoder_hidden_states.to(dt),
                          self.text_embedder_2(h5)], dim=1)
        if text_embedding_mask is not None and text_embedding_mask_t5 is not None:
            mask = torch.cat([text_embedding_mask, text_embedding_mask_t5],
                             dim=-1)
            text = torch.where(mask[..., None].bool(), text,
                               self.text_embedding_padding[None].to(dt))
        clip_ctx = None
        if clip_encoder_hidden_states is not None and cfg.enable_clip_in_inpaint:
            clip_ctx = self.clip_projection(clip_encoder_hidden_states.to(dt))
            if clip_attention_mask is not None:
                clip_ctx = torch.where(clip_attention_mask[..., None].bool(),
                                       clip_ctx, self.clip_padding[None].to(dt))
        half = cfg.num_layers // 2
        skips = []
        for layer, block in enumerate(self.blocks):
            x = block(x, text, temb, rope,
                      skip_states=skips.pop() if layer > half else None,
                      grid=grid, disable_rope_in_attn1=layer == 0,
                      clip_context=clip_ctx)
            if layer < half - 1:
                skips.append(x)
        # AdaLayerNormContinuous out
        shift, scale = self.norm_out_linear(
            F.silu(temb.float()).to(dt)).chunk(2, dim=-1)
        x = fp32_layer_norm(x, eps=cfg.norm_eps)
        x = x * (1 + scale[:, None]) + shift[:, None]
        return unpatchify(self.proj_out(x), *grid, p,
                          cfg.effective_out_channels)
