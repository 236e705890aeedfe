"""MagViT 3D causal video VAE, channels-first (B, C, T, H, W).

Parity: easyanimate_tpu/models/vae/magvit.py (reference
autoencoder_magvit.py:59-505, omnigen_enc_dec.py). Encoder + quant_conv and
post_quant_conv + decoder, with two chunk protocols: `cache_mag` (V5,
V5.1: frame 0 alone, then chunks that carry the causal conv caches,
mini_batch_encoder pixel frames per encoder pass) and `slice_mag` (V4:
independent chunks of mini_batch_encoder pixel or mini_batch_decoder latent
frames, each starting its causal convs afresh); the even-cover spatial
tiling; `smooth_output`, the slice modes' chunk-seam blend; and the
diagonal Gaussian's mode, sample and KL. The compression modes and `cog`
are not ported (ROADMAP queue 1 item 8). vae_encode, vae_decode and
latent_frame_count also take V1's 2D AutoencoderKL (kl2d.py), as JAX's do
(magvit.py:393-431, :642-645): frame-batched, one latent a frame, no chunk
protocol; the tiled paths refuse it by name (its tile size is 2^30, so the
pipelines never tile it).

encode_chunk and decode_chunk are differentiable (the VAE trainer,
training/vae_trainer.py, takes their gradients with cache=None): no layer
writes in place into a tensor that autograd saved.
"""
import dataclasses
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from .blocks import DownBlock3D, MidBlock3D, UpBlock3D, _sub
from .kl2d import AutoencoderKL, KL2DConfig
from .layers import CausalConv3d, Conv1x1x1, GroupNorm

CHUNK_MODES = ("cache_mag", "slice_mag")

_DOWN_KIND = {
    "SpatialDownBlock3D": "spatial",
    "TemporalDownBlock3D": "temporal",
    "SpatialTemporalDownBlock3D": "spatial_temporal",
    "DownBlock3D": None,
}
_UP_KIND = {
    "SpatialUpBlock3D": "spatial",
    "TemporalUpBlock3D": "temporal",
    "SpatialTemporalUpBlock3D": "spatial_temporal",
    "UpBlock3D": None,
}


@dataclasses.dataclass(frozen=True)
class MagvitVAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    down_block_types: Sequence[str] = (
        "SpatialDownBlock3D",
        "SpatialTemporalDownBlock3D",
        "SpatialTemporalDownBlock3D",
        "SpatialTemporalDownBlock3D",
    )
    up_block_types: Sequence[str] = (
        "SpatialUpBlock3D",
        "SpatialTemporalUpBlock3D",
        "SpatialTemporalUpBlock3D",
        "SpatialTemporalUpBlock3D",
    )
    layers_per_block: int = 2
    norm_num_groups: int = 32
    mid_block_attention_type: str = "spatial"
    mid_block_use_attention: bool = True
    spatial_group_norm: bool = True
    mini_batch_encoder: int = 4
    mini_batch_decoder: int = 1
    # latent frames per decoder pass after frame 0 (performance only: the
    # causal caches make the pass size irrelevant to the result); None =
    # mini_batch_decoder
    decode_chunk_frames: Optional[int] = None
    scaling_factor: float = 0.7119
    # 'cache_mag' (V5, V5.1) or 'slice_mag' (V4); the others raise
    chunk_mode: str = "cache_mag"
    tile_sample_min_size: int = 384
    tile_overlap_factor: float = 0.25
    dtype: str = "float32"

    def __post_init__(self):
        if self.chunk_mode not in CHUNK_MODES:
            raise NotImplementedError(
                f"VAE chunk mode {self.chunk_mode!r}: only {CHUNK_MODES} are "
                "ported (the other chunk modes: ROADMAP queue 1 item 8)")

    @property
    def temporal_compression(self) -> int:
        return 2 ** sum(1 for t in self.down_block_types[:-1] if "Temporal" in t)

    @property
    def spatial_compression(self) -> int:
        return 2 ** sum(1 for t in self.down_block_types[:-1] if "Spatial" in t)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


class Encoder(nn.Module):
    """conv_in, down blocks (the last without a downsampler), mid block,
    norm + silu, conv_out to 2 * latent_channels moments."""

    def __init__(self, cfg: MagvitVAEConfig, **fk):
        super().__init__()
        boc = list(cfg.block_out_channels)
        norm = dict(norm_num_groups=cfg.norm_num_groups,
                    spatial_norm=cfg.spatial_group_norm)
        self.conv_in = CausalConv3d(cfg.in_channels, boc[0], **fk)
        n = len(cfg.down_block_types)
        self.down_blocks = nn.ModuleList([
            DownBlock3D(boc[max(i - 1, 0)], boc[i], cfg.layers_per_block,
                        None if i == n - 1 else _DOWN_KIND[kind], **norm, **fk)
            for i, kind in enumerate(cfg.down_block_types)])
        self.mid_block = MidBlock3D(
            boc[-1], cfg.layers_per_block,
            (cfg.mid_block_attention_type if cfg.mid_block_use_attention
             else "none"), **norm, **fk)
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, boc[-1], 1e-6,
                                       cfg.spatial_group_norm, **fk)
        self.conv_out = CausalConv3d(boc[-1], 2 * cfg.latent_channels, **fk)

    def forward(self, x, cache=None):
        new_cache = {}
        x, new_cache["conv_in"] = self.conv_in(x, _sub(cache, "conv_in"))
        for i, block in enumerate(self.down_blocks):
            x, new_cache[f"down{i}"] = block(x, _sub(cache, f"down{i}"))
        x, new_cache["mid"] = self.mid_block(x, _sub(cache, "mid"))
        x = F.silu(self.conv_norm_out(x))
        x, new_cache["conv_out"] = self.conv_out(x, _sub(cache, "conv_out"))
        return x, new_cache


class Decoder(nn.Module):
    def __init__(self, cfg: MagvitVAEConfig, **fk):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        norm = dict(norm_num_groups=cfg.norm_num_groups,
                    spatial_norm=cfg.spatial_group_norm)
        self.conv_in = CausalConv3d(cfg.latent_channels, rev[0], **fk)
        self.mid_block = MidBlock3D(
            rev[0], cfg.layers_per_block,
            (cfg.mid_block_attention_type if cfg.mid_block_use_attention
             else "none"), **norm, **fk)
        n = len(cfg.up_block_types)
        self.up_blocks = nn.ModuleList([
            UpBlock3D(rev[max(i - 1, 0)], rev[i], cfg.layers_per_block + 1,
                      None if i == n - 1 else _UP_KIND[kind], **norm, **fk)
            for i, kind in enumerate(cfg.up_block_types)])
        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, rev[-1], 1e-6,
                                       cfg.spatial_group_norm, **fk)
        self.conv_out = CausalConv3d(rev[-1], cfg.out_channels, **fk)

    def forward(self, z, cache=None):
        new_cache = {}
        z, new_cache["conv_in"] = self.conv_in(z, _sub(cache, "conv_in"))
        z, new_cache["mid"] = self.mid_block(z, _sub(cache, "mid"))
        for i, block in enumerate(self.up_blocks):
            z, new_cache[f"up{i}"] = block(z, _sub(cache, f"up{i}"))
        z = F.silu(self.conv_norm_out(z))
        z, new_cache["conv_out"] = self.conv_out(z, _sub(cache, "conv_out"))
        return z, new_cache


class AutoencoderKLMagvit(nn.Module):
    """The MagViT VAE: encoder + quant_conv, post_quant_conv + decoder. Its
    parameters are the reference's state-dict keys."""

    def __init__(self, cfg: MagvitVAEConfig, device=None):
        """Parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=cfg.torch_dtype)
        self.encoder = Encoder(cfg, **fk)
        self.decoder = Decoder(cfg, **fk)
        self.quant_conv = Conv1x1x1(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, **fk)
        self.post_quant_conv = Conv1x1x1(cfg.latent_channels,
                                         cfg.latent_channels, **fk)

    def encode_chunk(self, x, cache=None):
        h, cache = self.encoder(x, cache)
        return self.quant_conv(h), cache

    def decode_chunk(self, z, cache=None):
        return self.decoder(self.post_quant_conv(z), cache)


def _chunked_apply(apply_fn: Callable, x: torch.Tensor, chunk: int):
    """cache_mag protocol: frame 0 alone, then chunks of `chunk` frames,
    threading the conv cache."""
    y, cache = apply_fn(x[:, :, :1], None)
    outs = [y]
    for i in range(1, x.shape[2], chunk):
        y, cache = apply_fn(x[:, :, i:i + chunk], cache)
        outs.append(y)
    return torch.cat(outs, dim=2)


def _slice_apply(apply_fn: Callable, x: torch.Tensor, chunk: int):
    """slice_mag protocol: independent chunks of `chunk` frames, each a
    fresh start of the causal convs (replicate-padded)."""
    return torch.cat([apply_fn(x[:, :, i:i + chunk], None)[0]
                      for i in range(0, x.shape[2], chunk)], dim=2)


def _run_chunks(vae: AutoencoderKLMagvit, apply_fn: Callable,
                x: torch.Tensor, chunk: int) -> torch.Tensor:
    """`apply_fn` over x in the VAE's chunk protocol."""
    if vae.cfg.chunk_mode == "slice_mag":
        return _slice_apply(apply_fn, x, chunk)
    return _chunked_apply(apply_fn, x, chunk)


def vae_encode(vae: AutoencoderKLMagvit, video: torch.Tensor) -> torch.Tensor:
    """video (B, C, T, H, W) in [-1, 1] -> moments (B, 2 * latent, T', H',
    W'), mean and logvar concatenated on C. cache_mag: frame 0 alone, then
    chunks of mini_batch_encoder frames (T = mini_batch_encoder * k + 1);
    slice_mag: independent chunks of mini_batch_encoder frames. V1's
    AutoencoderKL encodes every frame on its own."""
    if isinstance(vae, AutoencoderKL):
        return vae.encode(video)
    return _run_chunks(vae, vae.encode_chunk, video,
                       vae.cfg.mini_batch_encoder)


def gaussian_mode(moments: torch.Tensor) -> torch.Tensor:
    """The mean half of vae_encode's moments (B, 2C, ...)."""
    return moments.chunk(2, dim=1)[0]


def gaussian_sample(moments: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mean + exp(logvar / 2) * N(0, 1), logvar clamped to [-30, 20]; the
    N(0, 1) draw is `noise` when given, else drawn from `generator`."""
    mean, logvar = moments.chunk(2, dim=1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device, dtype=mean.dtype)
    return mean + std * noise.to(mean.dtype)


def gaussian_kl(moments: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) per sample, summed over the non-batch dims; logvar
    clamped to [-30, 20]."""
    mean, logvar = moments.chunk(2, dim=1)
    logvar = logvar.clamp(-30.0, 20.0)
    kl = 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar)
    return kl.flatten(1).sum(dim=1)


def _decode_chunk_frames(cfg: MagvitVAEConfig) -> int:
    """Latent frames per decoder pass: decode_chunk_frames under the cache
    protocol, where the pass size does not change the result; slice_mag's
    independent chunks are mini_batch_decoder frames, a size that does."""
    if cfg.chunk_mode == "slice_mag":
        return cfg.mini_batch_decoder
    return cfg.decode_chunk_frames or cfg.mini_batch_decoder


def vae_decode(vae: AutoencoderKLMagvit, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, C, T, H, W) -> pixels in [-1, 1] (no scaling_factor).
    V1's AutoencoderKL decodes every latent frame on its own."""
    if isinstance(vae, AutoencoderKL):
        return vae.decode(latents)
    return _run_chunks(vae, vae.decode_chunk, latents,
                       _decode_chunk_frames(vae.cfg))


def _blend_v(a, b, extent):
    """Blend the bottom rows of a into the top rows of b along H."""
    extent = min(a.shape[3], b.shape[3], extent)
    w = (torch.arange(extent, device=b.device) / extent).to(b.dtype)
    w = w.view(1, 1, 1, extent, 1)
    b = b.clone()
    b[:, :, :, :extent] = a[:, :, :, -extent:] * (1 - w) + b[:, :, :, :extent] * w
    return b


def _blend_h(a, b, extent):
    """Blend the right columns of a into the left columns of b along W."""
    extent = min(a.shape[4], b.shape[4], extent)
    w = (torch.arange(extent, device=b.device) / extent).to(b.dtype)
    w = w.view(1, 1, 1, 1, extent)
    b = b.clone()
    b[..., :extent] = a[..., -extent:] * (1 - w) + b[..., :extent] * w
    return b


def _tile_starts(dim: int, tile: int, stride: int) -> List[int]:
    """Even-cover tile starts: fixed stride, last tile end-aligned."""
    if dim <= tile:
        return [0]
    starts = list(range(0, dim - tile + 1, stride))
    if starts[-1] != dim - tile:
        starts.append(dim - tile)
    return starts


def _tiled(apply_chunked: Callable, x: torch.Tensor, tile_in: int,
           tile_out: int, overlap_factor: float) -> torch.Tensor:
    """Overlapping input tiles, linear seam blends over each pair's actual
    overlap (end-aligned tiles make the last overlap wider)."""
    stride = int(tile_in * (1 - overlap_factor))

    def out_px(e):
        return e * tile_out // tile_in

    si = _tile_starts(x.shape[3], tile_in, stride)
    sj = _tile_starts(x.shape[4], tile_in, stride)
    rows = [[apply_chunked(x[:, :, :, i:i + tile_in, j:j + tile_in])
             for j in sj] for i in si]
    out_rows = []
    for ii, i in enumerate(si):
        out_row = []
        for jj, j in enumerate(sj):
            tile = rows[ii][jj]
            if ii > 0:
                tile = _blend_v(rows[ii - 1][jj], tile,
                                out_px(si[ii - 1] + tile_in - i))
            if jj > 0:
                tile = _blend_h(rows[ii][jj - 1], tile,
                                out_px(sj[jj - 1] + tile_in - j))
            hi = (tile.shape[3] if ii == len(si) - 1
                  else out_px(si[ii + 1] - i))
            wi = (tile.shape[4] if jj == len(sj) - 1
                  else out_px(sj[jj + 1] - j))
            out_row.append(tile[:, :, :, :hi, :wi])
        out_rows.append(torch.cat(out_row, dim=4))
    return torch.cat(out_rows, dim=3)


def _refuse_kl2d(vae, what: str) -> None:
    if isinstance(vae, AutoencoderKL):
        raise TypeError(f"{what}: V1's AutoencoderKL is not tiled (its "
                        "tile_sample_min_size is 2^30, so the pipelines never "
                        "tile it); call vae_encode / vae_decode")


def vae_encode_tiled(vae: AutoencoderKLMagvit,
                     video: torch.Tensor) -> torch.Tensor:
    """Spatially tiled encode (tiles of tile_sample_min_size pixels)."""
    _refuse_kl2d(vae, "vae_encode_tiled")
    cfg = vae.cfg
    tile_in = cfg.tile_sample_min_size
    tile_out = tile_in // cfg.spatial_compression
    return _tiled(lambda x: vae_encode(vae, x), video, tile_in, tile_out,
                  cfg.tile_overlap_factor)


def vae_decode_tiled(vae: AutoencoderKLMagvit,
                     latents: torch.Tensor) -> torch.Tensor:
    """Spatially tiled decode (tiles of tile_sample_min_size pixels)."""
    _refuse_kl2d(vae, "vae_decode_tiled")
    cfg = vae.cfg
    tile_out = cfg.tile_sample_min_size
    tile_in = tile_out // cfg.spatial_compression
    chunk = _decode_chunk_frames(cfg)
    return _tiled(lambda z: _run_chunks(vae, vae.decode_chunk, z, chunk),
                  latents, tile_in, tile_out, cfg.tile_overlap_factor)


def smooth_output(vae: AutoencoderKLMagvit, video: torch.Tensor
                  ) -> torch.Tensor:
    """Chunk-seam smoothing of a slice-mode decode (JAX magvit.py:593-614,
    reference pipeline_easyanimate.py:706-742): the video without its
    first mini_batch_encoder // 2 and last mini_batch_encoder - that many
    frames is encoded (mode) and decoded again, so its chunks straddle the
    first pass's seams, and averaged into those frames. As in JAX the
    re-decode broadcasts when it comes back one frame long, and a re-decode
    of another length raises."""
    mbe = vae.cfg.mini_batch_encoder
    if video.shape[2] <= mbe:
        return video
    before, after = mbe // 2, mbe - mbe // 2
    middle = video[:, :, before:-after]
    redec = vae_decode(vae, gaussian_mode(vae_encode(vae, middle)))
    return torch.cat([video[:, :, :before], (middle + redec) / 2,
                      video[:, :, -after:]], dim=2)


def latent_frame_count(pixel_frames: int, cfg: MagvitVAEConfig) -> int:
    """The frame remap (pipeline_easyanimate.py:677-688): cache_mag,
    (f - 1) // mini_batch_encoder * mini_batch_decoder + 1; slice_mag,
    f // temporal_compression; V1's KL2D, f (one latent a frame)."""
    if isinstance(cfg, KL2DConfig):
        return pixel_frames
    if cfg.chunk_mode == "slice_mag":
        return pixel_frames // cfg.temporal_compression
    return ((pixel_frames - 1) // cfg.mini_batch_encoder
            * cfg.mini_batch_decoder + 1)
