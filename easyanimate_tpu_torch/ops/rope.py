"""Rotary position embeddings for the video tokens.

Parity: easyanimate_tpu/ops/rope.py (diffusers get_3d_rotary_pos_embed as
used by pipeline_easyanimate.py:998-1019, and get_2d_rotary_pos_embed, V4's
single-frame tables). The tables are built on the host
in numpy; `apply_rotary_emb` is the interleaved form -- pairs (x0, x1)
rotate to (x0 cos - x1 sin, x1 cos + x0 sin) -- on q and k kept in the
reference feature order.
"""
from typing import Tuple

import numpy as np
import torch


def get_resize_crop_region_for_grid(src, tgt_width, tgt_height):
    """Aspect-preserving crop region of a (tgt_height, tgt_width) base grid
    for an (h, w) target grid."""
    h, w = src
    r = h / w
    if r > (tgt_height / tgt_width):
        resize_height = tgt_height
        resize_width = int(round(tgt_height / h * w))
    else:
        resize_width = tgt_width
        resize_height = int(round(tgt_width / w * h))
    crop_top = int(round((tgt_height - resize_height) / 2.0))
    crop_left = int(round((tgt_width - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height,
                                   crop_left + resize_width)


def get_1d_rotary_pos_embed(dim: int, pos: np.ndarray, theta: float = 10000.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each [len(pos), dim], repeat-interleaved by 2."""
    if dim % 2:
        raise ValueError(f"rope dim {dim} must be even")
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64)[: dim // 2]
                             / dim))
    angles = np.outer(np.asarray(pos, dtype=np.float64), freqs)
    cos = np.repeat(np.cos(angles), 2, axis=1).astype(np.float32)
    sin = np.repeat(np.sin(angles), 2, axis=1).astype(np.float32)
    return cos, sin


def get_2d_rotary_pos_embed(embed_dim: int, crops_coords,
                            grid_size: Tuple[int, int], theta: float = 10000.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """2D RoPE over an (h, w) grid, the features split half and half between
    the axes (h first). Returns (cos, sin), each [h*w, embed_dim] float32."""
    (top, left), (bottom, right) = crops_coords
    gh, gw = grid_size
    grid_h = np.linspace(top, bottom, gh, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(left, right, gw, endpoint=False, dtype=np.float32)
    h_cs = get_1d_rotary_pos_embed(embed_dim // 2, grid_h, theta)
    w_cs = get_1d_rotary_pos_embed(embed_dim // 2, grid_w, theta)

    def combine(hp, wp):
        return np.concatenate([
            np.broadcast_to(hp[:, None, :], (gh, gw, hp.shape[-1])),
            np.broadcast_to(wp[None, :, :], (gh, gw, wp.shape[-1])),
        ], axis=-1).reshape(gh * gw, -1)

    return combine(h_cs[0], w_cs[0]), combine(h_cs[1], w_cs[1])


def get_3d_rotary_pos_embed(embed_dim: int, crops_coords,
                            grid_size: Tuple[int, int], temporal_size: int,
                            theta: float = 10000.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """3D RoPE: features split t: d/4, h: 3d/8, w: 3d/8; tokens in (t, h, w)
    row-major order. Returns (cos, sin), each [T*H*W, embed_dim] float32."""
    (top, left), (bottom, right) = crops_coords
    gh, gw = grid_size
    grid_h = np.linspace(top, bottom, gh, endpoint=False, dtype=np.float32)
    grid_w = np.linspace(left, right, gw, endpoint=False, dtype=np.float32)
    grid_t = np.linspace(0, temporal_size, temporal_size, endpoint=False,
                         dtype=np.float32)
    dim_t = embed_dim // 4
    dim_hw = embed_dim // 8 * 3
    t_cs = get_1d_rotary_pos_embed(dim_t, grid_t, theta)
    h_cs = get_1d_rotary_pos_embed(dim_hw, grid_h, theta)
    w_cs = get_1d_rotary_pos_embed(dim_hw, grid_w, theta)

    def combine(tp, hp, wp):
        shape = (temporal_size, gh, gw)
        out = np.concatenate([
            np.broadcast_to(tp[:, None, None, :], (*shape, tp.shape[-1])),
            np.broadcast_to(hp[None, :, None, :], (*shape, hp.shape[-1])),
            np.broadcast_to(wp[None, None, :, :], (*shape, wp.shape[-1])),
        ], axis=-1)
        return out.reshape(temporal_size * gh * gw, -1)

    return (combine(t_cs[0], h_cs[0], w_cs[0]),
            combine(t_cs[1], h_cs[1], w_cs[1]))


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor) -> torch.Tensor:
    """Rotate interleaved pairs of the last axis of x [..., S, D] by the
    repeat-interleaved tables cos/sin [S, D]. float32 math, cast back."""
    x32 = x.float()
    pairs = x32.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return (x32 * cos.float() + rot * sin.float()).to(x.dtype)
