"""Qwen2 / Qwen2-VL text tower: the V5.1 prompt encoder.

Parity: easyanimate_tpu/models/text/qwen2.py. The reference encodes prompts
with Qwen2VLForConditionalGeneration(...).hidden_states[-2]
(pipeline_easyanimate.py:455-461): the embeddings and all but the last
decoder layer, no final norm. For text-only prompts Qwen2-VL's M-RoPE is
the standard half-rotation RoPE, so this is a plain Qwen2 decoder stack:
RMSNorm, GQA causal attention (q, k, v with biases), SwiGLU MLP.

Attention is computed as JAX computes it (qwen2.py:93-97), with no kernel:
float32 scores from torch.matmul, an additive -1e9 float32 bias for
`causal & key_mask`, softmax, p cast to the value dtype. Parameter names
are the HF keys without their prefix (`embed_tokens.weight`,
`layers.{i}.self_attn.q_proj.weight`, ...).
"""
import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...ops.norms import fp32_rms_norm


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    rope_theta: float = 1000000.0
    rms_norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


TINY_QWEN = Qwen2Config(
    vocab_size=128, hidden_size=32, intermediate_size=64,
    num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
    dtype="float32")


def rope_tables(cfg: Qwen2Config, seq_len: int, device=None):
    """HF-style RoPE: cos, sin [S, head_dim] float32 in the halves layout;
    the inverse frequencies in float64, then cast (JAX qwen2.py:54-60)."""
    hd = cfg.head_dim
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    inv = torch.from_numpy(inv.astype(np.float32)).to(device)
    ang = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope_half(x, cos, sin):
    """HF rotate_half convention, in float32, cast back to x's dtype."""
    h = x.shape[-1] // 2
    rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, **fk):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return fp32_rms_norm(x, self.weight, self.eps)


class Qwen2Attention(nn.Module):
    def __init__(self, cfg: Qwen2Config, **fk):
        super().__init__()
        hd = cfg.head_dim
        self.cfg = cfg
        self.q_proj = nn.Linear(cfg.hidden_size, cfg.num_attention_heads * hd,
                                **fk)
        self.k_proj = nn.Linear(cfg.hidden_size, cfg.num_key_value_heads * hd,
                                **fk)
        self.v_proj = nn.Linear(cfg.hidden_size, cfg.num_key_value_heads * hd,
                                **fk)
        self.o_proj = nn.Linear(cfg.num_attention_heads * hd, cfg.hidden_size,
                                bias=False, **fk)

    def forward(self, x, cos, sin, attn_bias):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim

        def heads(a, n):
            return a.view(b, s, n, hd).transpose(1, 2)

        q = apply_rope_half(heads(self.q_proj(x), cfg.num_attention_heads),
                            cos, sin)
        k = apply_rope_half(heads(self.k_proj(x), cfg.num_key_value_heads),
                            cos, sin)
        v = heads(self.v_proj(x), cfg.num_key_value_heads)
        # GQA: each kv head repeated in place (jnp.repeat on the head axis)
        rep = cfg.num_attention_heads // cfg.num_key_value_heads
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        p = torch.softmax(scores + attn_bias, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, s, -1)
        return self.o_proj(o)


class Qwen2MLP(nn.Module):
    def __init__(self, cfg: Qwen2Config, **fk):
        super().__init__()
        d, f = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(d, f, bias=False, **fk)
        self.up_proj = nn.Linear(d, f, bias=False, **fk)
        self.down_proj = nn.Linear(f, d, bias=False, **fk)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Qwen2Layer(nn.Module):
    def __init__(self, cfg: Qwen2Config, **fk):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **fk)
        self.self_attn = Qwen2Attention(cfg, **fk)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps, **fk)
        self.mlp = Qwen2MLP(cfg, **fk)

    def forward(self, x, cos, sin, attn_bias):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, attn_bias)
        return x + self.mlp(self.post_attention_layernorm(x))


class Qwen2TextEncoder(nn.Module):
    """Embeddings + the first N - 1 decoder layers (hidden_states[-2]), or
    all N with drop_last_layer=False. Parameters on `device`, the card by
    default."""

    def __init__(self, cfg: Qwen2Config, drop_last_layer: bool = True,
                 device=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=cfg.torch_dtype)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size, **fk)
        n = cfg.num_hidden_layers - (1 if drop_last_layer else 0)
        self.layers = nn.ModuleList([Qwen2Layer(cfg, **fk) for _ in range(n)])

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, S] (and the tokenizer's 0/1 mask) -> [B, S, D]."""
        s = input_ids.shape[1]
        dev = input_ids.device
        cos, sin = rope_tables(self.cfg, s, dev)
        mask = torch.ones(s, s, dtype=torch.bool, device=dev).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask[:, None, None, :].bool()
        attn_bias = torch.where(mask, 0.0, -1e9).to(torch.float32)
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, cos, sin, attn_bias)
        return x


QWEN2_PREFIXES = ("model.", "model.language_model.", "language_model.model.",
                  "")


def qwen2_state_dict(module: Qwen2TextEncoder,
                     sd: Mapping[str, torch.Tensor]) -> dict:
    """The tensors of an HF Qwen2(-VL) checkpoint that `module` holds, under
    its own names. Each key is looked up under the prefixes `model.`,
    `model.language_model.`, `language_model.model.` and none, in that
    order (JAX convert_qwen2_state_dict); what the tower never reads
    (lm_head, visual.*, the final norm, the dropped last layer) is left out.
    Raises KeyError naming every tensor of the tower that is missing."""
    out, missing = {}, []
    for name in module.state_dict():
        key = next((p + name for p in QWEN2_PREFIXES if p + name in sd), None)
        if key is None:
            missing.append(name)
        else:
            out[name] = sd[key]
    if missing:
        raise KeyError(f"Qwen2 checkpoint lacks {len(missing)} tower tensors: "
                       f"{missing[:6]}")
    return out


def load_qwen2_state_dict(module: Qwen2TextEncoder,
                          sd: Mapping[str, torch.Tensor]) -> None:
    """Load an HF Qwen2(-VL) state dict into `module` (strict on the tower's
    own tensors, see qwen2_state_dict); values cast to each parameter's
    dtype and device."""
    module.load_state_dict(qwen2_state_dict(module, sd), strict=True)
