"""Dual-stream MMDiT transformer blocks (EasyAnimate V5/V5.1).

Parity: easyanimate_tpu/models/blocks.py (reference EasyAnimateLayerNormZero
norm.py:135-166, EasyAnimateDiTBlock attention.py:1027-1163,
EasyAnimateAttnProcessor2_0 processor.py:218-312). Module and parameter
names are the reference's state-dict keys, so a reference-layout dict loads
with strict=True. q and k stay in the reference (interleaved) feature order
and take the interleaved RoPE; the JAX package's de-interleave is TPU layout
work that leaves the scores unchanged. With `linear_quant` ("int8", "int4"
or "w4a8", JAX MMDiTBlock.quant) the block linears (q, k, v and out of
both streams, both FFN linears) are ops/quant.py QuantLinears under the
same names; q, k and v share one quantize of their input.
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import joint_attention
from ..ops.norms import fp32_layer_norm
from ..ops.quant import QuantLinear, make_linear
from ..ops.rope import apply_rotary_emb
from ..ops.swa import swa_attention_streams


class LayerNormZero(nn.Module):
    """AdaLN-zero over two streams with a shared LayerNorm; the modulation
    chunks are shift, scale, gate, enc_shift, enc_scale, enc_gate."""

    def __init__(self, dim: int, time_dim: int, eps: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.linear = nn.Linear(time_dim, 6 * dim, device=device, dtype=dtype)
        self.norm = nn.LayerNorm(dim, eps=eps, device=device, dtype=dtype)

    def forward(self, vid, txt, temb):
        shift, scale, gate, e_shift, e_scale, e_gate = self.linear(
            F.silu(temb)).chunk(6, dim=-1)

        def norm(x):
            return fp32_layer_norm(x, self.norm.weight, self.norm.bias,
                                   self.eps)

        vid = norm(vid) * (1 + scale[:, None]) + shift[:, None]
        txt = norm(txt) * (1 + e_scale[:, None]) + e_shift[:, None]
        return vid, txt, gate[:, None], e_gate[:, None]


class StreamQKV(nn.Module):
    """q/k/v projections, per-head LayerNorm qk-norm (eps 1e-6) and the
    output projection of one stream (reference diffusers Attention)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 qk_norm: bool = True, *, linear_quant: Optional[str] = None,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        inner = num_heads * head_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.to_q = make_linear(dim, inner, linear_quant, **fk)
        self.to_k = make_linear(dim, inner, linear_quant, **fk)
        self.to_v = make_linear(dim, inner, linear_quant, **fk)
        self.qk_norm = qk_norm
        if qk_norm:
            self.norm_q = nn.LayerNorm(head_dim, eps=1e-6, **fk)
            self.norm_k = nn.LayerNorm(head_dim, eps=1e-6, **fk)
        self.to_out = nn.ModuleList([make_linear(inner, dim, linear_quant,
                                                 **fk)])

    def forward(self, x):
        """x [B, S, dim] -> q, k, v [B, H, S, D]."""
        def heads(a):
            return a.unflatten(-1, (self.num_heads, self.head_dim)).transpose(1, 2)

        if isinstance(self.to_q, QuantLinear):
            xq = self.to_q.quantize_input(x)  # one Q1 for q, k and v
            q, k, v = (heads(lin(x, xq))
                       for lin in (self.to_q, self.to_k, self.to_v))
        else:
            q, k, v = heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x))
        if self.qk_norm:
            q = fp32_layer_norm(q, self.norm_q.weight, self.norm_q.bias, 1e-6)
            k = fp32_layer_norm(k, self.norm_k.weight, self.norm_k.bias, 1e-6)
        return q, k, v

    def out(self, o):
        """o [B, H, S, D] -> [B, S, dim]."""
        return self.to_out[0](o.transpose(1, 2).flatten(2))


class _GELUProj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, linear_quant=None, **fk):
        super().__init__()
        self.proj = make_linear(dim_in, dim_out, linear_quant, **fk)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """gelu-tanh MLP with 4x inner width (diffusers FeedForward; net.1 is
    the reference's dropout slot)."""

    def __init__(self, dim: int, mult: int = 4, *,
                 linear_quant: Optional[str] = None, device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        self.net = nn.ModuleList([
            _GELUProj(dim, dim * mult, linear_quant, **fk), nn.Identity(),
            make_linear(dim * mult, dim, linear_quant, **fk)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class MMDiTBlock(nn.Module):
    """Joint attention + per-stream FFN with AdaLN-zero.

    is_mmdit=True gives the text stream its own QKV/out/FFN; False shares
    the video stream's over the concatenated sequence. is_swa runs the
    sliding-window composition (ops/swa.py) instead of dense attention."""

    def __init__(self, dim: int, time_dim: int, num_heads: int, head_dim: int,
                 *, qk_norm: bool = True, after_norm: bool = False,
                 is_mmdit: bool = True, is_swa: bool = False,
                 norm_eps: float = 1e-6, linear_quant: Optional[str] = None,
                 device=None, dtype=None):
        super().__init__()
        fk = dict(device=device, dtype=dtype)
        qk = dict(fk, linear_quant=linear_quant)
        self.is_mmdit = is_mmdit
        self.is_swa = is_swa
        self.after_norm = after_norm
        self.norm_eps = norm_eps
        self.norm1 = LayerNormZero(dim, time_dim, norm_eps, **fk)
        self.attn1 = StreamQKV(dim, num_heads, head_dim, qk_norm, **qk)
        if is_mmdit:
            self.attn2 = StreamQKV(dim, num_heads, head_dim, qk_norm, **qk)
        self.norm2 = LayerNormZero(dim, time_dim, norm_eps, **fk)
        self.ff = FeedForward(dim, **qk)
        if is_mmdit:
            self.txt_ff = FeedForward(dim, **qk)
        if after_norm:
            self.norm3 = nn.LayerNorm(dim, eps=norm_eps, **fk)

    def forward(self, vid, txt, temb,
                rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                grid_size: Optional[Tuple[int, int, int]] = None):
        st = txt.shape[1]
        n_vid, n_txt, gate, e_gate = self.norm1(vid, txt, temb)

        if self.is_mmdit:
            qv, kv, vv = self.attn1(n_vid)
            qt, kt, vt = self.attn2(n_txt)
        else:
            qj, kj, vj = self.attn1(torch.cat([n_txt, n_vid], dim=1))
            qt, qv = qj[:, :, :st], qj[:, :, st:]
            kt, kv = kj[:, :, :st], kj[:, :, st:]
            vt, vv = vj[:, :, :st], vj[:, :, st:]

        if self.is_swa:
            if rope is not None:
                qv = apply_rotary_emb(qv, *rope)
                kv = apply_rotary_emb(kv, *rope)
            gf, gh, gw = grid_size
            o_t, o_v = swa_attention_streams(qt, kt, vt, qv, kv, vv,
                                             num_frames=gf, height=gh,
                                             width=gw)
        else:
            cos, sin = rope if rope is not None else (None, None)
            o_t, o_v = joint_attention(qt, kt, vt, qv, kv, vv, cos, sin)

        o_vid = self.attn1.out(o_v)
        o_txt = (self.attn2 if self.is_mmdit else self.attn1).out(o_t)
        vid = vid + gate * o_vid
        txt = txt + e_gate * o_txt

        n_vid, n_txt, gate2, e_gate2 = self.norm2(vid, txt, temb)
        f_vid = self.ff(n_vid)
        f_txt = (self.txt_ff if self.is_mmdit else self.ff)(n_txt)
        if self.after_norm:
            w3, b3 = self.norm3.weight, self.norm3.bias
            f_vid = fp32_layer_norm(f_vid, w3, b3, self.norm_eps)
            f_txt = fp32_layer_norm(f_txt, w3, b3, self.norm_eps)
        return vid + gate2 * f_vid, txt + e_gate2 * f_txt
