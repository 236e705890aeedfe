"""CLIP text and vision towers in plain PyTorch (the reward models' backbone).

The JAX package runs transformers' FlaxCLIPModel (easyanimate_tpu/reward/
reward_fn.py); the card machine has no transformers, so the port carries
the towers itself, with the same arithmetic:
  - pre-LN encoder layers (layer_norm1 -> attention -> residual,
    layer_norm2 -> MLP -> residual), `hidden_act` from the config: "gelu"
    (exact erf, CLIP-H) or "quick_gelu" (x * sigmoid(1.702 x), OpenAI's);
  - the text tower's causal mask combined with the padding mask, masked
    scores set to the dtype's most negative value, as Flax does;
  - the text pooling of FlaxCLIPTextTransformer: the row of the first
    `eos_token_id` in each sequence, or of the largest id when the config's
    eos_token_id is 2 (the pre-fix configs);
  - the vision tower's class token through post_layernorm;
  - attention as plain matmul + softmax (CLIP-H's head_dim is 80, which no
    attention kernel of the port takes; the JAX side runs no Pallas here).

Parameters carry Hugging Face's torch state-dict names, so a reference
checkpoint directory (config.json + *.safetensors) loads with strict=True
through utils/safetensors_io.py (`from_pretrained`). The tokenizer is a
callable the caller passes, with the Hugging Face tokenizer interface
(`tok(prompts, padding=, truncation=, max_length=, return_tensors=)` ->
{"input_ids", "attention_mask"}, and `model_max_length`).
"""
import dataclasses
import json
import os
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.convert import load_on_device
from ..utils.safetensors_io import load_dir


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    num_channels: int = 3
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    text_config: CLIPTextConfig = CLIPTextConfig()
    vision_config: CLIPVisionConfig = CLIPVisionConfig()
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592

    @classmethod
    def from_dict(cls, d: Mapping) -> "CLIPConfig":
        """A Hugging Face CLIP config.json's dict (unknown keys ignored)."""
        def pick(kind, sub):
            names = {f.name for f in dataclasses.fields(kind)}
            return kind(**{k: v for k, v in (sub or {}).items() if k in names})

        return cls(text_config=pick(CLIPTextConfig, d.get("text_config")),
                   vision_config=pick(CLIPVisionConfig, d.get("vision_config")),
                   projection_dim=d.get("projection_dim", 512),
                   logit_scale_init_value=d.get("logit_scale_init_value",
                                                2.6592))


# published widths: laion/CLIP-ViT-H-14-laion2B-s32B-b79K (the backbone of
# HPS v2 and PickScore, and of MPS) and openai/clip-vit-large-patch14 (the
# aesthetic predictor's)
CLIP_PRESETS = {
    "clip-vit-h-14": CLIPConfig(
        CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                       num_hidden_layers=24, num_attention_heads=16,
                       hidden_act="gelu"),
        CLIPVisionConfig(hidden_size=1280, intermediate_size=5120,
                         num_hidden_layers=32, num_attention_heads=16,
                         patch_size=14, hidden_act="gelu"),
        projection_dim=1024),
    "clip-vit-l-14": CLIPConfig(
        CLIPTextConfig(hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=12, num_attention_heads=12),
        CLIPVisionConfig(hidden_size=1024, intermediate_size=4096,
                         num_hidden_layers=24, num_attention_heads=16,
                         patch_size=14),
        projection_dim=768),
}


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "gelu":
        return F.gelu
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    raise ValueError(f"unsupported CLIP hidden_act {name!r}")


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int, **fk):
        super().__init__()
        self.heads = heads
        self.k_proj = nn.Linear(dim, dim, **fk)
        self.v_proj = nn.Linear(dim, dim, **fk)
        self.q_proj = nn.Linear(dim, dim, **fk)
        self.out_proj = nn.Linear(dim, dim, **fk)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """x (B, S, D); mask bool (B, 1, S, S) or None, True = attend."""
        b, s, d = x.shape
        hd = d // self.heads

        def heads(t):
            return t.reshape(b, s, self.heads, hd).transpose(1, 2)

        q = heads(self.q_proj(x)) / hd ** 0.5
        k, v = heads(self.k_proj(x)), heads(self.v_proj(x))
        scores = q @ k.transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        o = torch.softmax(scores.float(), dim=-1).to(v.dtype) @ v
        return self.out_proj(o.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str, **fk):
        super().__init__()
        self.act = _activation(act)
        self.fc1 = nn.Linear(dim, hidden, **fk)
        self.fc2 = nn.Linear(hidden, dim, **fk)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.self_attn = CLIPAttention(d, cfg.num_attention_heads, **fk)
        self.layer_norm1 = nn.LayerNorm(d, eps=eps, **fk)
        self.mlp = CLIPMLP(d, cfg.intermediate_size, cfg.hidden_act, **fk)
        self.layer_norm2 = nn.LayerNorm(d, eps=eps, **fk)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg, **fk):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg, **fk)
                                     for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            **fk)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size, **fk)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, **fk):
        super().__init__()
        self.cfg = cfg
        self.embeddings = CLIPTextEmbeddings(cfg, **fk)
        self.encoder = CLIPEncoder(cfg, **fk)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps, **fk)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids (B, S) -> (last_hidden_state (B, S, D) after the final norm,
        pooled (B, D) at the EOS row)."""
        s = input_ids.shape[1]
        mask = torch.ones(s, s, dtype=torch.bool,
                          device=input_ids.device).tril()[None, None]
        if attention_mask is not None:
            mask = mask & attention_mask.bool()[:, None, None, :]
        x = self.encoder(self.embeddings(input_ids), mask)
        x = self.final_layer_norm(x)
        if self.cfg.eos_token_id == 2:
            eos = input_ids.argmax(dim=-1)
        else:
            eos = (input_ids == self.cfg.eos_token_id).int().argmax(dim=-1)
        return x, x[torch.arange(x.shape[0], device=x.device), eos]


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **fk):
        super().__init__()
        d, p = cfg.hidden_size, cfg.patch_size
        self.class_embedding = nn.Parameter(torch.empty(d, **fk))
        self.patch_embedding = nn.Conv2d(cfg.num_channels, d, p, stride=p,
                                         bias=False, **fk)
        n = (cfg.image_size // p) ** 2 + 1
        self.position_embedding = nn.Embedding(n, d, **fk)

    def forward(self, pixel_values):
        x = self.patch_embedding(pixel_values).flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig, **fk):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.embeddings = CLIPVisionEmbeddings(cfg, **fk)
        self.pre_layrnorm = nn.LayerNorm(d, eps=eps, **fk)
        self.encoder = CLIPEncoder(cfg, **fk)
        self.post_layernorm = nn.LayerNorm(d, eps=eps, **fk)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pixels (B, C, H, W) -> (last_hidden_state (B, 1 + N, D), before
        post_layernorm as in Hugging Face; pooled (B, D): the class token
        through post_layernorm)."""
        x = self.encoder(self.pre_layrnorm(self.embeddings(pixel_values)))
        return x, self.post_layernorm(x[:, 0])


class CLIPModel(nn.Module):
    """Both towers, their projections and logit_scale (log of the
    temperature; exponentiated where a score is computed)."""

    def __init__(self, cfg: CLIPConfig, device=None):
        """float32 parameters on `device`, the card by default."""
        super().__init__()
        self.cfg = cfg
        fk = dict(device=resolve_device(device), dtype=torch.float32)
        t, v = cfg.text_config, cfg.vision_config
        self.text_model = CLIPTextTransformer(t, **fk)
        self.vision_model = CLIPVisionTransformer(v, **fk)
        self.visual_projection = nn.Linear(v.hidden_size, cfg.projection_dim,
                                           bias=False, **fk)
        self.text_projection = nn.Linear(t.hidden_size, cfg.projection_dim,
                                         bias=False, **fk)
        self.logit_scale = nn.Parameter(
            torch.full((), cfg.logit_scale_init_value, **fk))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    def get_text_features(self, input_ids, attention_mask=None):
        return self.text_projection(self.text_model(input_ids,
                                                    attention_mask)[1])

    def get_image_features(self, pixel_values):
        return self.visual_projection(self.vision_model(
            pixel_values.float())[1])

    @classmethod
    def from_pretrained(cls, path: str, device=None) -> "CLIPModel":
        """A Hugging Face CLIP directory (config.json + *.safetensors),
        built on meta and loaded strictly on `device` (the card by
        default). `position_ids` buffers of older checkpoints are dropped,
        as Hugging Face drops them."""
        with open(os.path.join(path, "config.json")) as f:
            cfg = CLIPConfig.from_dict(json.load(f))
        sd = {k: v for k, v in load_dir(path).items()
              if not k.endswith(".position_ids")}
        return load_on_device(cls(cfg, device="meta"), sd, device)


def tokenize(tokenizer, prompts, max_length: Optional[int] = None,
             device=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """prompts -> (input_ids int64, attention_mask or None) on `device`,
    padded to max_length (the tokenizer's model_max_length when it is
    below 1e6, else 77, as the JAX package asks)."""
    if max_length is None:
        mml = getattr(tokenizer, "model_max_length", 77)
        max_length = mml if mml < 1e6 else 77
    ids = tokenizer(list(prompts), padding="max_length", truncation=True,
                    max_length=max_length, return_tensors="np")
    mask = ids.get("attention_mask")
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                     device=device)
    return as_t(ids["input_ids"]), None if mask is None else as_t(mask)
