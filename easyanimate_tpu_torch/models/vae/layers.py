"""Primitives of the MagViT 3D causal VAE, channels-first (B, C, T, H, W).

Parity: easyanimate_tpu/models/vae/layers.py. The reference's stateful
padding-flag protocol (vaemodules/common.py:31-179) is one functional rule:
  * cache is None -> start of the sequence: replicate-pad (t_ks - 1) frames
    in front;
  * cache is a tensor -> continuation: prepend the cached frames (a
    temporal stride-2 conv takes one fewer, reference common.py:120-127);
  * every call returns the new cache, the last (t_ks - 1) frames of its
    temporal input, so chunked decoding equals full-sequence decoding.
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Cache = Optional[torch.Tensor]


class CausalConv3d(nn.Conv3d):
    """3D conv, temporally causal; weight in the reference layout
    (O, I, T, H, W). Spatially zero-padded to keep the size, or by
    `spatial_padding` ((top, bottom), (left, right)): the stride-2 spatial
    downsamplers pad ((0, 1), (0, 1)), as the reference's F.pad(x, (0, 1, 0,
    1)) before a pad-0 conv."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=1,
                 spatial_padding: Optional[Tuple[Tuple[int, int],
                                                 Tuple[int, int]]] = None,
                 *, device=None, dtype=None):
        pad = (kernel_size - 1) // 2
        self.spatial_padding = spatial_padding
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=(0, pad, pad) if spatial_padding is None else 0,
                         device=device, dtype=dtype)

    def forward(self, x: torch.Tensor, cache: Cache = None
                ) -> Tuple[torch.Tensor, Cache]:
        t_pad = self.kernel_size[0] - 1
        if t_pad:
            if cache is None:
                front = x[:, :, :1].expand(-1, -1, t_pad, -1, -1)
            else:
                # a stride-2 window starts one frame later in the cache
                front = cache[:, :, 1:] if self.stride[0] == 2 else cache
                front = front.to(x.dtype)
            x = torch.cat([front, x], dim=2)
            # clone: a view would keep the whole concatenated input alive
            new_cache = x[:, :, -t_pad:].clone()
        else:
            new_cache = None
        if self.spatial_padding is not None:
            (top, bottom), (left, right) = self.spatial_padding
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x), new_cache


class Conv1x1x1(nn.Conv3d):
    """Pointwise 3D conv (post-quant and shortcut convs); weight
    (O, I, 1, 1, 1) as in the reference."""

    def __init__(self, in_channels: int, out_channels: int, *, device=None,
                 dtype=None):
        super().__init__(in_channels, out_channels, 1, device=device,
                         dtype=dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-6,
               spatial: bool = True) -> torch.Tensor:
    """GroupNorm over (B, C, T, H, W) with float32 statistics.

    spatial=True normalizes each frame on its own (the reference's
    spatial_group_norm, used by V5/V5.1 so chunked and full decoding
    agree); spatial=False normalizes over the whole clip."""
    b, c, t, h, w = x.shape
    if spatial:
        xg = x.reshape(b, num_groups, c // num_groups, t, h * w).float()
        dims = (2, 4)
    else:
        xg = x.reshape(b, num_groups, c // num_groups, t * h * w).float()
        dims = (2, 3)
    var, mean = torch.var_mean(xg, dim=dims, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, c, t, h, w)
    y = y * weight.float().view(1, c, 1, 1, 1) + bias.float().view(1, c, 1, 1, 1)
    return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters with the per-frame group_norm above."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6,
                 spatial: bool = True, *, device=None, dtype=None):
        super().__init__(num_groups, num_channels, eps=eps, device=device,
                         dtype=dtype)
        self.spatial = spatial

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, self.spatial)
