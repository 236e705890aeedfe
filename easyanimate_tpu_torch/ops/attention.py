"""Attention entry points over [B, H, S, D]: the sm_scale fold and dispatch
to K1 (K3 + K4 in the backward), and the MMDiT joint text+video
composition.

Reference behaviour (easyanimate/models/processor.py:218-312): concat text
first, RoPE on the video slice of q and k, one attention over the concat.
Unlike the JAX entry, no pad-to-block copy is needed: the kernel masks the
ragged edge itself. Without a sequence-parallel scope the JAX
`dispatch_attention` is this `attention`.
"""
from typing import Optional

import torch

from .flash_attention import LOG2E, FlashAttention, flash_attention_plain
from .rope import apply_rotary_emb


def prescale(q: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """Fold sm_scale * log2(e) into q and round back to q's dtype, so the
    kernel and its plain version see the same rounded q."""
    return (q * (sm_scale * LOG2E)).to(q.dtype)


def check_attn_impl(attn_impl: str) -> None:
    """A model config's `attn_impl`, kept for JAX's field set: JAX's
    HunyuanDiT and Transformer3D read it nowhere (transformer3d_legacy.py's
    attn_impl_resolved returns "auto"), and the port sends every bias-free
    attention to K1, so a setting other than "auto" is refused rather than
    ignored."""
    if attn_impl != "auto":
        raise ValueError(f"attn_impl {attn_impl!r}: the port runs every "
                         "model attention on K1 (its plain version on a CPU "
                         "tensor); only 'auto' is accepted")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: Optional[float] = None,
              kv_valid: Optional[int] = None,
              impl: str = "kernel") -> torch.Tensor:
    """Softmax attention [B, H, Sq, D] x [B, H, Skv, D] -> [B, H, Sq, D].

    impl 'kernel' goes through the FlashAttention autograd Function (K1,
    and K3 + K4 in the backward, on a CUDA tensor; their plain versions on a
    CPU tensor); 'plain' always takes the plain q-chunked math, which
    autograd differentiates as it is (the VAE mid-block attention, which the
    JAX package runs as XLA too). The sm_scale * log2(e) fold stays outside
    the Function, as in JAX, so autograd applies its chain rule to dq."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = prescale(q, sm_scale).reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, skv, d).contiguous()
    vf = v.reshape(b * h, skv, d).contiguous()
    if impl == "kernel":
        o = FlashAttention.apply(qf, kf, vf, kv_valid)
    elif impl == "plain":
        o, _ = flash_attention_plain(qf, kf, vf, kv_valid)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    return o.reshape(b, h, sq, d)


def biased_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention [B, H, S, D] with an additive float32 bias [B, Sq,
    Skv] (a text mask's -10000 on padding): JAX's dense einsums outside
    any kernel (hunyuan.py:151-158, transformer3d_legacy.py:151-158), so
    plain float32 matmuls here; p is cast to v's dtype before p @ v."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores * q.shape[-1] ** -0.5 + bias[:, None].float()
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)


def joint_attention(q_txt, k_txt, v_txt, q_vid, k_vid, v_vid,
                    rope_cos: Optional[torch.Tensor] = None,
                    rope_sin: Optional[torch.Tensor] = None):
    """Fused text+video attention: concat (text first), RoPE on video q/k,
    one attention pass, split back. All tensors [B, H, S, D]. Like the
    reference, it runs unmasked over text padding (pad the embeddings with
    zeros). Returns (out_txt, out_vid)."""
    if rope_cos is not None:
        q_vid = apply_rotary_emb(q_vid, rope_cos, rope_sin)
        k_vid = apply_rotary_emb(k_vid, rope_cos, rope_sin)
    st = q_txt.shape[2]
    q = torch.cat([q_txt, q_vid], dim=2)
    k = torch.cat([k_txt, k_vid], dim=2)
    v = torch.cat([v_txt, v_vid], dim=2)
    o = attention(q, k, v)
    return o[:, :, :st], o[:, :, st:]
