"""Norms computed in float32 whatever the input dtype.

Parity: easyanimate_tpu/ops/norms.py (reference FP32LayerNorm /
EasyAnimateRMSNorm, easyanimate/models/norm.py:16-42).
"""
from typing import Optional

import torch
from torch import nn


def fp32_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics and affine."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fp32_rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 variance; the weight is applied after the
    downcast, as the reference does (norm.py:39)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(x.dtype)
    if weight is not None:
        y = weight.to(x.dtype) * y
    return y


class RMSNorm(nn.Module):
    """fp32_rms_norm with a learned `weight` (the Qwen2 tower's norms, and
    the norm in front of V5's text projections, at JAX's eps 1e-6)."""

    def __init__(self, dim: int, eps: float = 1e-6, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return fp32_rms_norm(x, self.weight, self.eps)
