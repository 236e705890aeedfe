"""Bert text tower: the V5 prompt encoder's first stream.

Parity: the `transformers.FlaxBertModel` that easyanimate_tpu/models/text/
encoders.py:21-40 runs (its last_hidden_state). The reference's V5
directories hold HunyuanDiT's Bert ("clip_text_encoder", a BertModel of
hidden 1024). Post-LN encoder: word + token-type (0) + position (0..S-1)
embeddings, LayerNorm (eps 1e-12); per layer q, k, v with biases, scores
q / sqrt(d) . k, an additive float32-minimum bias on padded keys, softmax,
the output dense, LayerNorm(x + attention), the 4x FFN with exact (erf)
GELU, LayerNorm(x + ffn).

The tower computes in float32, the JAX package's dtype (Flax's default),
on the card too. Attention runs as the Qwen2 tower's does: torch.matmul
scores and softmax, no kernel of ours (the per-row key mask is not K1's
interface). Parameter names are the HF torch keys
(`embeddings.word_embeddings.weight`,
`encoder.layer.{i}.attention.self.query.weight`, ...), which are also the
FlaxBertModel's paths (models/convert.py::state_dict_from_flax).
"""
import dataclasses
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device


@dataclasses.dataclass(frozen=True)
class BertConfig:
    # HunyuanDiT's clip_text_encoder/config.json (a BertModel), the tower of
    # alibaba-pai/EasyAnimateV5-12b-zh's text_encoder; the vocabulary only
    # sets the embedding's row count
    vocab_size: int = 47020
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_json(cls, cfg: Mapping) -> "BertConfig":
        """An HF BertConfig's config.json fields; the others keep their
        defaults. Only the exact GELU of `hidden_act: gelu` is ported."""
        act = cfg.get("hidden_act", "gelu")
        if act != "gelu":
            raise ValueError(f"Bert hidden_act {act!r}: only 'gelu' is ported")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names})


TINY_BERT = BertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64,
                       max_position_embeddings=80)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        d = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, d, **fk)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                d, **fk)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, d, **fk)
        self.LayerNorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, **fk)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        # Flax's order: words + token types + positions
        x = (self.word_embeddings(input_ids)
             + self.token_type_embeddings.weight[0]
             + self.position_embeddings(pos)[None])
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        d = cfg.hidden_size
        self.cfg = cfg
        self.query = nn.Linear(d, d, **fk)
        self.key = nn.Linear(d, d, **fk)
        self.value = nn.Linear(d, d, **fk)

    def forward(self, x, attn_bias):
        b, s, _ = x.shape
        n, hd = self.cfg.num_attention_heads, self.cfg.head_dim

        def heads(a):
            return a.view(b, s, n, hd).transpose(1, 2)

        q = heads(self.query(x)) / math.sqrt(hd)
        scores = torch.matmul(q, heads(self.key(x)).transpose(-1, -2))
        p = torch.softmax(scores + attn_bias, dim=-1)
        return torch.matmul(p, heads(self.value(x))).transpose(1, 2).reshape(
            b, s, -1)


class BertDenseNorm(nn.Module):
    """dense, then LayerNorm(output + residual): Bert's SelfOutput and
    Output."""

    def __init__(self, d_in: int, d: int, eps: float, **fk):
        super().__init__()
        self.dense = nn.Linear(d_in, d, **fk)
        self.LayerNorm = nn.LayerNorm(d, eps=eps, **fk)

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        self.self = BertSelfAttention(cfg, **fk)
        self.output = BertDenseNorm(cfg.hidden_size, cfg.hidden_size,
                                    cfg.layer_norm_eps, **fk)

    def forward(self, x, attn_bias):
        return self.output(self.self(x, attn_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **fk)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact (erf) GELU


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        self.attention = BertAttention(cfg, **fk)
        self.intermediate = BertIntermediate(cfg, **fk)
        self.output = BertDenseNorm(cfg.intermediate_size, cfg.hidden_size,
                                    cfg.layer_norm_eps, **fk)

    def forward(self, x, attn_bias):
        x = self.attention(x, attn_bias)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, **fk):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, **fk)
                                    for _ in range(cfg.num_hidden_layers)])


class BertModel(nn.Module):
    """The BertModel's embeddings and encoder (no pooler): token ids ->
    last_hidden_state. float32 parameters on `device`, the card by
    default."""

    def __init__(self, cfg: BertConfig = BertConfig(), device=None):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=torch.float32)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg, **fk)
        self.encoder = BertEncoder(cfg, **fk)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [B, S] (and the tokenizer's 0/1 mask) -> [B, S, D]."""
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones(b, s, device=input_ids.device)
        # Flax: lax.select(mask > 0, 0, finfo(float32).min) on padded keys
        attn_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0,
                                torch.finfo(torch.float32).min)
        x = self.embeddings(input_ids)
        for layer in self.encoder.layer:
            x = layer(x, attn_bias)
        return x


# keys of an HF Bert checkpoint that the tower never reads, dropped by name
BERT_DROPPED = ("pooler.dense.weight", "pooler.dense.bias")
_BERT_POSITION_IDS = "embeddings.position_ids"


def bert_state_dict(module: BertModel, sd: Mapping[str, torch.Tensor]
                    ) -> dict:
    """An HF BertModel checkpoint (keys as saved, with or without the
    `bert.` prefix) -> the tower's state dict. `pooler.*` is dropped by
    name; the `embeddings.position_ids` buffer older checkpoints carry is
    checked to be 0..P-1 and dropped. Any other key the tower lacks, and
    any tower tensor the checkpoint lacks, raises KeyError."""
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):] if k.startswith("bert.") else k: v
              for k, v in sd.items()}
    sd = dict(sd)
    pos_ids = sd.pop(_BERT_POSITION_IDS, None)
    if pos_ids is not None:
        want = torch.arange(module.cfg.max_position_embeddings)
        if not torch.equal(torch.as_tensor(pos_ids).reshape(-1).long(), want):
            raise ValueError(f"{_BERT_POSITION_IDS} is not 0..P-1")
    for k in BERT_DROPPED:
        sd.pop(k, None)
    names = set(module.state_dict())
    unexpected = sorted(set(sd) - names)
    missing = sorted(names - set(sd))
    if unexpected or missing:
        raise KeyError(f"Bert checkpoint: {len(missing)} tower tensors "
                       f"missing {missing[:6]}, {len(unexpected)} unexpected "
                       f"keys {unexpected[:6]}")
    return sd

