"""MagViT VAE blocks, channels-first, with functional conv caches.

Parity: easyanimate_tpu/models/vae/blocks.py (reference
vaemodules/common.py:254-323, down_blocks.py:156-330, downsamplers.py:24-93,
up_blocks.py:96-395, upsamplers.py, mid_blocks.py:38-196,
attention.py:391-470). Every cached module's forward takes (x, cache dict |
None) and returns (y, new cache dict); `cache is None` marks the first chunk
of a sequence. GlobalContextBlock (use_gc_blocks) is not ported: no V5.1
config enables it.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import attention
from .layers import CausalConv3d, Conv1x1x1, GroupNorm


def _sub(cache, name):
    return None if cache is None else cache.get(name)


class ResidualBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 norm_num_groups: int = 32, norm_eps: float = 1e-6,
                 spatial_norm: bool = True, **fk):
        super().__init__()
        self.norm1 = GroupNorm(norm_num_groups, in_channels, norm_eps,
                               spatial_norm, **fk)
        self.conv1 = CausalConv3d(in_channels, out_channels, **fk)
        self.norm2 = GroupNorm(norm_num_groups, out_channels, norm_eps,
                               spatial_norm, **fk)
        self.conv2 = CausalConv3d(out_channels, out_channels, **fk)
        self.shortcut = (Conv1x1x1(in_channels, out_channels, **fk)
                         if in_channels != out_channels else None)

    def forward(self, x, cache=None):
        new_cache = {}
        h, new_cache["conv1"] = self.conv1(F.silu(self.norm1(x)),
                                           _sub(cache, "conv1"))
        h, new_cache["conv2"] = self.conv2(F.silu(self.norm2(h)),
                                           _sub(cache, "conv2"))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return h + shortcut, new_cache


class VAEAttention(nn.Module):
    """Single-head attention over a frame's tokens ('spatial'), a pixel's
    frames ('temporal') or the whole clip ('3d'), with GroupNorm in front
    and a residual around it. Plain math, as the JAX package runs it."""

    def __init__(self, channels: int, mode: str, norm_num_groups: int = 32,
                 norm_eps: float = 1e-6, spatial_norm: bool = True, **fk):
        super().__init__()
        if mode not in ("spatial", "temporal", "3d"):
            raise ValueError(f"unknown VAE attention mode {mode!r}")
        self.mode = mode
        self.group_norm = GroupNorm(norm_num_groups, channels, norm_eps,
                                    spatial_norm, **fk)
        self.to_q = nn.Linear(channels, channels, **fk)
        self.to_k = nn.Linear(channels, channels, **fk)
        self.to_v = nn.Linear(channels, channels, **fk)
        self.to_out = nn.Linear(channels, channels, **fk)

    def forward(self, x):
        b, c, t, h, w = x.shape
        y = self.group_norm(x).permute(0, 2, 3, 4, 1)  # (b, t, h, w, c)
        if self.mode == "spatial":
            tokens = y.reshape(b * t, h * w, c)
        elif self.mode == "temporal":
            tokens = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        else:
            tokens = y.reshape(b, t * h * w, c)
        q, k, v = (proj(tokens)[:, None] for proj in
                   (self.to_q, self.to_k, self.to_v))
        o = self.to_out(attention(q, k, v, impl="plain")[:, 0])
        if self.mode == "temporal":
            o = o.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        else:
            o = o.reshape(b, t, h, w, c)
        return o.permute(0, 4, 1, 2, 3) + x


_DOWN_STRIDES = {"spatial": (1, 2, 2), "temporal": (2, 1, 1),
                 "spatial_temporal": (2, 2, 2)}


class Downsampler3D(nn.Module):
    """One stride-2 causal conv; the spatial kinds pad ((0, 1), (0, 1))
    (downsamplers.py:24-93)."""

    def __init__(self, channels: int, kind: str, **fk):
        super().__init__()
        spad = ((0, 1), (0, 1)) if "spatial" in kind else None
        self.conv = CausalConv3d(channels, channels, stride=_DOWN_STRIDES[kind],
                                 spatial_padding=spad, **fk)

    def forward(self, x, cache=None):
        y, c = self.conv(x, _sub(cache, "conv"))
        return y, {"conv": c}


class DownBlock3D(nn.Module):
    """Residual convs, then the optional downsampler (down_blocks.py)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 2, downsample: Optional[str] = None,
                 norm_num_groups: int = 32, norm_eps: float = 1e-6,
                 spatial_norm: bool = True, **fk):
        super().__init__()
        self.convs = nn.ModuleList([
            ResidualBlock3D(in_channels if i == 0 else out_channels,
                            out_channels, norm_num_groups, norm_eps,
                            spatial_norm, **fk)
            for i in range(num_layers)])
        self.downsampler = (None if downsample is None
                            else Downsampler3D(out_channels, downsample, **fk))

    def forward(self, x, cache=None):
        new_cache = {}
        for i, res in enumerate(self.convs):
            x, new_cache[f"res{i}"] = res(x, _sub(cache, f"res{i}"))
        if self.downsampler is not None:
            x, new_cache["down"] = self.downsampler(x, _sub(cache, "down"))
        return x, new_cache


def _spatial_up(x):
    return F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")


def _trilinear_time2x(v):
    """F.interpolate(scale_factor=(2, 1, 1), mode='trilinear',
    align_corners=False) along the time axis (dim 2)."""
    t = v.shape[2]
    pos = (torch.arange(2 * t, device=v.device, dtype=torch.float32) + 0.5) / 2 - 0.5
    lo = pos.floor().long().clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    frac = (pos - lo).clamp(0.0, 1.0).to(v.dtype).view(1, 1, -1, 1, 1)
    return v[:, :, lo] * (1 - frac) + v[:, :, hi] * frac


def _temporal_first_frame_up(x, first_chunk: bool):
    if first_chunk and x.shape[2] > 1:
        return torch.cat([x[:, :, :1], _trilinear_time2x(x[:, :, 1:])], dim=2)
    if not first_chunk:
        return _trilinear_time2x(x)
    return x


class SpatialUpsampler3D(nn.Module):
    """Nearest 2x in h and w, then a causal conv."""

    def __init__(self, channels: int, **fk):
        super().__init__()
        self.conv = CausalConv3d(channels, channels, **fk)

    def forward(self, x, cache=None):
        return self.conv(_spatial_up(x), cache)


class TemporalUpsampler3D(nn.Module):
    """2x in time (the first chunk keeps frame 0), then a causal conv."""

    def __init__(self, channels: int, **fk):
        super().__init__()
        self.conv = CausalConv3d(channels, channels, **fk)

    def forward(self, x, cache=None):
        return self.conv(_temporal_first_frame_up(x, cache is None), cache)


class SpatialTemporalUpsampler3D(nn.Module):
    """Nearest 2x spatial -> causal conv -> 2x temporal (upsamplers.py:
    142-153, cache_mag rule): the first chunk keeps frame 0 and doubles the
    rest, later chunks double fully; nearest with spatial group norm, else
    trilinear."""

    def __init__(self, channels: int, spatial_norm: bool = True, **fk):
        super().__init__()
        self.spatial_norm = spatial_norm
        self.conv = CausalConv3d(channels, channels, **fk)

    def _time_up(self, v):
        if self.spatial_norm:
            return v.repeat_interleave(2, dim=2)
        return _trilinear_time2x(v)

    def forward(self, x, cache=None):
        x, new_cache = self.conv(_spatial_up(x), cache)
        if cache is not None:
            x = self._time_up(x)
        elif x.shape[2] > 1:
            x = torch.cat([x[:, :, :1], self._time_up(x[:, :, 1:])], dim=2)
        return x, new_cache


_UPSAMPLERS = {
    "spatial": SpatialUpsampler3D,
    "temporal": TemporalUpsampler3D,
    "spatial_temporal": SpatialTemporalUpsampler3D,
}


class UpBlock3D(nn.Module):
    """Residual convs, then the optional upsampler (up_blocks.py:137-148)."""

    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 3, upsample: Optional[str] = None,
                 norm_num_groups: int = 32, norm_eps: float = 1e-6,
                 spatial_norm: bool = True, **fk):
        super().__init__()
        self.convs = nn.ModuleList([
            ResidualBlock3D(in_channels if i == 0 else out_channels,
                            out_channels, norm_num_groups, norm_eps,
                            spatial_norm, **fk)
            for i in range(num_layers)])
        if upsample is None:
            self.upsampler = None
        elif upsample == "spatial_temporal":
            self.upsampler = SpatialTemporalUpsampler3D(out_channels,
                                                        spatial_norm, **fk)
        else:
            self.upsampler = _UPSAMPLERS[upsample](out_channels, **fk)

    def forward(self, x, cache=None):
        new_cache = {}
        for i, res in enumerate(self.convs):
            x, new_cache[f"res{i}"] = res(x, _sub(cache, f"res{i}"))
        if self.upsampler is not None:
            x, new_cache["up"] = self.upsampler(x, _sub(cache, "up"))
        return x, new_cache


class MidBlock3D(nn.Module):
    """res0, then (attention, res_i) for i in 1..num_layers-1."""

    def __init__(self, channels: int, num_layers: int = 2,
                 attention_type: str = "spatial", norm_num_groups: int = 32,
                 norm_eps: float = 1e-6, spatial_norm: bool = True, **fk):
        super().__init__()
        self.convs = nn.ModuleList([
            ResidualBlock3D(channels, channels, norm_num_groups, norm_eps,
                            spatial_norm, **fk)
            for _ in range(num_layers)])
        if attention_type == "none":
            self.attentions = None
        else:
            self.attentions = nn.ModuleList([
                VAEAttention(channels, attention_type, norm_num_groups,
                             norm_eps, spatial_norm, **fk)
                for _ in range(num_layers - 1)])

    def forward(self, x, cache=None):
        new_cache = {}
        x, new_cache["res0"] = self.convs[0](x, _sub(cache, "res0"))
        for i in range(1, len(self.convs)):
            if self.attentions is not None:
                x = self.attentions[i - 1](x)
            x, new_cache[f"res{i}"] = self.convs[i](x, _sub(cache, f"res{i}"))
        return x, new_cache
