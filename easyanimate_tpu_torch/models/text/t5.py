"""mT5 encoder tower: the V5 prompt encoder's second stream (and the V1-V3
editions' only one).

Parity: the `transformers.FlaxMT5EncoderModel` that easyanimate_tpu/models/
text/encoders.py:43-62 runs (its last_hidden_state). Pre-norm T5 blocks:
the `shared` embedding; per block the T5 RMS norm (no mean, no bias,
variance in float32, x / sqrt(var + eps), eps 1e-6), attention without the
1/sqrt(d) scale plus a relative-position bias, then the T5 norm and the
gated-GELU FFN (gelu(wi_0 x) * wi_1 x -> wo, tanh GELU); a final norm.
The bias comes from block 0's `relative_attention_bias` table over
bidirectional buckets (32 buckets, max distance 128: 8 exact offsets each
way, then log-spaced ones) and is reused by every block, with the
float32-minimum mask of padded keys added to it, as Flax does.

The tower computes in float32, the JAX package's dtype (Flax's default),
on the card too. Attention runs as the Qwen2 tower's does: torch.matmul
scores and softmax, no kernel of ours (K1 takes neither the additive bias
nor a per-row key mask). The norms are ops/norms.py's RMSNorm in Flax
T5's rounding (T5LayerNorm). Parameter names are the HF torch keys
(`shared.weight`, `encoder.block.{i}.layer.0.SelfAttention.q.weight`,
...), which are also the Flax tower's paths
(models/convert.py::state_dict_from_flax).
"""
import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...ops.norms import RMSNorm


@dataclasses.dataclass(frozen=True)
class T5Config:
    # google/mt5-xl's config.json, the encoder of
    # alibaba-pai/EasyAnimateV5-12b-zh's text_encoder_2
    vocab_size: int = 250112
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @classmethod
    def from_json(cls, cfg: Mapping) -> "T5Config":
        """An HF T5 / MT5 config.json's fields; the others keep their
        defaults. Only the gated-GELU FFN (mT5, T5 v1.1) is ported. UMT5 is
        refused: it holds a relative_attention_bias table in every block,
        where this tower (as the JAX package's Flax mT5) builds one in block
        0 and reuses it."""
        if cfg.get("model_type") == "umt5":
            raise NotImplementedError(
                "umt5 text encoder: UMT5 has a relative_attention_bias table "
                "in every block; the mT5 tower reads block 0's alone")
        ff = cfg.get("feed_forward_proj", "gated-gelu")
        if ff != "gated-gelu":
            raise ValueError(f"T5 feed_forward_proj {ff!r}: only 'gated-gelu' "
                             "(mT5, T5 v1.1) is ported")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names})


TINY_T5 = T5Config(vocab_size=96, d_model=32, d_kv=8, d_ff=48, num_layers=2,
                   num_heads=4)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """Bidirectional T5 buckets of memory - query offsets (Flax
    _relative_position_bucket): half the buckets for positive offsets;
    offsets below num_buckets / 4 exact, the rest log-spaced up to
    max_distance, in float32 as Flax computes them."""
    half = num_buckets // 2
    buckets = (rel > 0).long() * half
    rel = rel.abs()
    max_exact = half // 2
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    large = max_exact + (torch.log(rel.float() / max_exact) / log_ratio
                         * (half - max_exact))
    large = large.clamp(max=half - 1).long()
    return buckets + torch.where(rel < max_exact, rel, large)


class T5LayerNorm(RMSNorm):
    """ops/norms.py's RMSNorm (float32 variance, no mean, no bias) in Flax
    T5's rounding, x / sqrt(var + eps), where the shared norm multiplies by
    rsqrt(var + eps): that one rounding, carried through the blocks, moves
    the mT5 tower's output past test_torch_v5_text.py's 1e-5 from Flax's."""

    def forward(self, x):
        var = x.square().mean(dim=-1, keepdim=True)
        return self.weight * (x / torch.sqrt(var + self.eps))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, **fk):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.d_model, cfg.inner_dim
        self.q = nn.Linear(d, inner, bias=False, **fk)
        self.k = nn.Linear(d, inner, bias=False, **fk)
        self.v = nn.Linear(d, inner, bias=False, **fk)
        self.o = nn.Linear(inner, d, bias=False, **fk)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads, **fk)

    def position_bias(self, s: int, device) -> torch.Tensor:
        """[1, heads, S, S] from this block's table."""
        pos = torch.arange(s, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        b, s, _ = x.shape
        n, hd = self.cfg.num_heads, self.cfg.d_kv

        def heads(a):
            return a.view(b, s, n, hd).transpose(1, 2)

        scores = torch.matmul(heads(self.q(x)),
                              heads(self.k(x)).transpose(-1, -2))
        p = torch.softmax(scores + bias, dim=-1)
        return self.o(torch.matmul(p, heads(self.v(x))).transpose(1, 2)
                      .reshape(b, s, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, **fk):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias, **fk)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **fk)

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config, **fk):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False, **fk)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config, **fk):
        super().__init__()
        self.DenseReluDense = T5DenseGatedActDense(cfg, **fk)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon,
                                      **fk)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool, **fk):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, has_relative_bias, **fk),
            T5LayerFF(cfg, **fk)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, **fk):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0, **fk)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon, **fk)


class MT5EncoderModel(nn.Module):
    """The `shared` embedding and the encoder stack: token ids ->
    last_hidden_state. float32 parameters on `device`, the card by
    default."""

    def __init__(self, cfg: T5Config = T5Config(), device=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=torch.float32)
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model, **fk)
        self.encoder = T5Stack(cfg, **fk)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, S] (and the tokenizer's 0/1 mask) -> [B, S, D]."""
        s = input_ids.shape[1]
        blocks = self.encoder.block
        # block 0's bias, reused by every block, with the padded keys'
        # float32-minimum mask added once
        bias = blocks[0].layer[0].SelfAttention.position_bias(
            s, input_ids.device)
        if attention_mask is not None:
            bias = bias + torch.where(attention_mask[:, None, None, :] > 0,
                                      0.0, torch.finfo(torch.float32).min)
        x = self.shared(input_ids)
        for block in blocks:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x)


# keys of a full (seq2seq) T5 / mT5 checkpoint that the encoder never
# reads, dropped by these prefixes
T5_DROPPED_PREFIXES = ("decoder.", "lm_head.")
_T5_TIED = "encoder.embed_tokens.weight"


def t5_state_dict(module: MT5EncoderModel, sd: Mapping[str, torch.Tensor]
                  ) -> dict:
    """An HF T5 / MT5 checkpoint (MT5EncoderModel's or a full
    MT5ForConditionalGeneration's) -> the encoder's state dict.

    Two traps: `encoder.embed_tokens.weight` is tied to `shared.weight`, and
    safetensors files often keep only one of them (usually `shared`), so
    either fills `shared` and the other is dropped; a full model's
    `decoder.*` and `lm_head.*` are dropped by name. Any other key the
    tower lacks, and any tower tensor the checkpoint lacks, raises
    KeyError."""
    sd = {k: v for k, v in sd.items()
          if not k.startswith(T5_DROPPED_PREFIXES)}
    tied = sd.pop(_T5_TIED, None)
    if "shared.weight" not in sd and tied is not None:
        sd["shared.weight"] = tied
    names = set(module.state_dict())
    unexpected = sorted(set(sd) - names)
    missing = sorted(names - set(sd))
    if unexpected or missing:
        raise KeyError(f"T5 checkpoint: {len(missing)} tower tensors missing "
                       f"{missing[:6]}, {len(unexpected)} unexpected keys "
                       f"{unexpected[:6]}")
    return sd

