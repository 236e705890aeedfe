"""AutoencoderKL: the SD-style 2D image VAE of the V1 edition, run over
video frame by frame.

Parity: easyanimate_tpu/models/vae/kl2d.py (diffusers' AutoencoderKL, which
the reference builds for vae_kwargs.vae_type "AutoencoderKL",
config/easyanimate_video_v1_motion_module.yaml). conv_in -> down blocks
(layers_per_block resnets each, a stride-2 downsample with diffusers'
asymmetric (0, 1) pad between them) -> mid (resnet, attention, resnet) ->
GroupNorm, SiLU, conv_out -> quant_conv; the mirrored decoder (one more
resnet a block, nearest 2x upsample + conv) after post_quant_conv. The
frames fold into the batch axis: (B, C, T, H, W) in and out, one latent a
frame. The mid-block attention is one float32 softmax over a frame's
h * w tokens, as in JAX: the plain attention, as the MagViT's
VAEAttention runs it (no TPU kernel ran it).

Parameter names are diffusers' AutoencoderKL keys, the ones JAX's
convert_kl2d_state_dict consumes, so a diffusers state dict loads with
strict=True. The GroupNorms compute in float32 with float32 affines (JAX's
nn.GroupNorm(dtype=float32)); convs and linears hold the config's dtype
and cast their input to it.
"""
import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...ops.attention import attention


@dataclasses.dataclass(frozen=True)
class KL2DConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def spatial_compression(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    # the MagViT configs' chunk-protocol fields, so that the pipelines treat
    # the 2D VAE as a chunkless, seamless, never-tiled member of the family
    # (JAX kl2d.py:26-65)
    @property
    def temporal_compression(self) -> int:
        return 1

    @property
    def chunk_mode(self) -> str:
        return "none"

    @property
    def tile_sample_min_size(self) -> int:
        return 1 << 30  # frame-batched 2D convs: no spatial tiling

    @property
    def mini_batch_encoder(self) -> int:
        return 1

    @property
    def mini_batch_decoder(self) -> int:
        return 1


class _Conv(nn.Conv2d):
    """Conv2d that casts its input to its weight's dtype."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class _GroupNorm(nn.GroupNorm):
    """GroupNorm (eps 1e-6) in float32 with float32 affines; the output
    stays float32, as flax's GroupNorm(dtype=float32) returns it."""

    def __init__(self, groups: int, channels: int, device=None):
        super().__init__(groups, channels, eps=1e-6, device=device,
                         dtype=torch.float32)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps)


class _Resnet(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int, **fk):
        super().__init__()
        dev = fk["device"]
        self.norm1 = _GroupNorm(groups, in_ch, dev)
        self.conv1 = _Conv(in_ch, out_ch, 3, padding=1, **fk)
        self.norm2 = _GroupNorm(groups, out_ch, dev)
        self.conv2 = _Conv(out_ch, out_ch, 3, padding=1, **fk)
        if in_ch != out_ch:
            self.conv_shortcut = _Conv(in_ch, out_ch, 1, **fk)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class _MidAttention(nn.Module):
    """One head over a frame's h * w tokens: group_norm, q, k, v, the
    plain float32 softmax attention, to_out.0, residual."""

    def __init__(self, ch: int, groups: int, **fk):
        super().__init__()
        self.group_norm = _GroupNorm(groups, ch, fk["device"])
        self.to_q = nn.Linear(ch, ch, **fk)
        self.to_k = nn.Linear(ch, ch, **fk)
        self.to_v = nn.Linear(ch, ch, **fk)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch, **fk)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2).to(
            self.to_q.weight.dtype)  # (b, hw, c)
        q, k, v = (proj(y)[:, None] for proj in
                   (self.to_q, self.to_k, self.to_v))
        o = self.to_out[0](attention(q, k, v, impl="plain")[:, 0])
        return x + o.transpose(1, 2).reshape(b, c, h, w)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int, **fk):
        super().__init__()
        self.resnets = nn.ModuleList([_Resnet(ch, ch, groups, **fk),
                                      _Resnet(ch, ch, groups, **fk)])
        self.attentions = nn.ModuleList([_MidAttention(ch, groups, **fk)])

    def forward(self, x):
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class _Sampler(nn.Module):
    """diffusers' Downsample2D / Upsample2D: its conv under `conv`."""

    def __init__(self, ch: int, stride: int, padding: int, **fk):
        super().__init__()
        self.conv = _Conv(ch, ch, 3, stride=stride, padding=padding, **fk)


class _DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, down: bool, **fk):
        super().__init__()
        self.resnets = nn.ModuleList([
            _Resnet(in_ch if j == 0 else out_ch, out_ch, groups, **fk)
            for j in range(layers)])
        if down:
            self.downsamplers = nn.ModuleList([_Sampler(out_ch, 2, 0, **fk)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):  # asymmetric (0, 1) pad
            x = self.downsamplers[0].conv(F.pad(x, (0, 1, 0, 1)))
        return x


class _UpBlock(nn.Module):
    def __init__(self, in_ch, out_ch, layers, groups, up: bool, **fk):
        super().__init__()
        self.resnets = nn.ModuleList([
            _Resnet(in_ch if j == 0 else out_ch, out_ch, groups, **fk)
            for j in range(layers)])
        if up:
            self.upsamplers = nn.ModuleList([_Sampler(out_ch, 1, 1, **fk)])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0].conv(
                F.interpolate(x, scale_factor=2.0, mode="nearest"))
        return x


class Encoder2D(nn.Module):
    def __init__(self, cfg: KL2DConfig, **fk):
        super().__init__()
        ch, g, n = cfg.block_out_channels, cfg.norm_num_groups, \
            len(cfg.block_out_channels)
        self.conv_in = _Conv(cfg.in_channels, ch[0], 3, padding=1, **fk)
        self.down_blocks = nn.ModuleList([
            _DownBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block, g,
                       i < n - 1, **fk) for i in range(n)])
        self.mid_block = _MidBlock(ch[-1], g, **fk)
        self.conv_norm_out = _GroupNorm(g, ch[-1], fk["device"])
        self.conv_out = _Conv(ch[-1], 2 * cfg.latent_channels, 3, padding=1,
                              **fk)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder2D(nn.Module):
    def __init__(self, cfg: KL2DConfig, **fk):
        super().__init__()
        ch, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        n = len(ch)
        self.conv_in = _Conv(cfg.latent_channels, ch[0], 3, padding=1, **fk)
        self.mid_block = _MidBlock(ch[0], g, **fk)
        self.up_blocks = nn.ModuleList([
            _UpBlock(ch[max(i - 1, 0)], ch[i], cfg.layers_per_block + 1, g,
                     i < n - 1, **fk) for i in range(n)])
        self.conv_norm_out = _GroupNorm(g, ch[-1], fk["device"])
        self.conv_out = _Conv(ch[-1], cfg.out_channels, 3, padding=1, **fk)

    def forward(self, z):
        z = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            z = block(z)
        return self.conv_out(F.silu(self.conv_norm_out(z)))


class AutoencoderKL(nn.Module):
    """Frame-batched 2D KL VAE with the video VAEs' (B, C, T, H, W) API."""

    def __init__(self, cfg: KL2DConfig = KL2DConfig(), device=None):
        """Parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=cfg.torch_dtype)
        self.encoder = Encoder2D(cfg, **fk)
        self.decoder = Decoder2D(cfg, **fk)
        self.quant_conv = _Conv(2 * cfg.latent_channels,
                                2 * cfg.latent_channels, 1, **fk)
        self.post_quant_conv = _Conv(cfg.latent_channels, cfg.latent_channels,
                                     1, **fk)

    @staticmethod
    def _frames(fn, x):
        """fn over the frames of x (B, C, T, H, W), folded into the batch."""
        b, c, t, h, w = x.shape
        y = fn(x.transpose(1, 2).reshape(b * t, c, h, w))
        return y.reshape(b, t, *y.shape[1:]).transpose(1, 2)

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        """(B, 3, T, H, W) -> moments (B, 2 * latent, T, H / 8, W / 8)."""
        return self._frames(lambda x: self.quant_conv(self.encoder(x)), video)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (B, latent, T, h, w) -> pixels (B, 3, T, 8h, 8w)."""
        return self._frames(lambda z: self.decoder(self.post_quant_conv(z)),
                            latents)
