"""MPS (Multi-dimensional Preference Score) reward model.

Parity: easyanimate_tpu/reward/mps.py (reference reward_fn.py:256-344 and
the vendored cross-attention scorer MPS/trainer/models/cross_modeling.py:
CrossAttention :172-258, ParallelTransformerBlock :78-170, Cross_model
:261-290; clip_model.py's condition mask :126-129 and first-token output
:143).

Per-token projected CLIP-H features of the image (257 tokens), the prompt
(77) and a fixed "condition" prompt; a mask keeps the prompt tokens whose
largest similarity to a condition token exceeds 0.01 of the largest such
similarity in the whole batch; 4 cross / self layers refine the image
tokens against the masked prompt; the reward is the cosine of the refined
class token and the prompt's EOS feature.

The cross model's parameters carry the reference's torch names
(`layers.N.0.fn.*`, the cross-attention; `layers.N.1.fn.*`, the parallel
block), so convert_mps_cross_state_dict only picks and renames nothing.
Its LayerNorms keep the JAX package's eps, 1e-6 (Flax's default).
"""
import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .clip import CLIPModel, tokenize
from .reward_fn import _preprocess, _subsample

MPS_CONDITION = ("light, color, clarity, tone, style, ambiance, artistry, "
                 "shape, face, hair, hands, limbs, structure, instance, "
                 "texture, quantity, attributes, position, number, location, "
                 "word, things.")
_LN_EPS = 1e-6


def _rotary(positions: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """rotate-half rotary embedding (cross_modeling.py:43-66) on the last
    dim, positions (N,) along dim -2."""
    d = t.shape[-1]
    inv = 1.0 / (10000 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = positions[:, None].float() * torch.from_numpy(inv).to(t.device)[None]
    emb = torch.cat([ang, ang], dim=-1)
    t1, t2 = t.float().chunk(2, dim=-1)
    rot = torch.cat([-t2, t1], dim=-1)
    return (t * emb.cos() + rot * emb.sin()).to(t.dtype)


class _LayerNorm(nn.Module):
    """LayerNorm with a learned gain and no bias (the reference's `gamma`)."""

    def __init__(self, dim: int, **fk):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, **fk))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.gamma.float(),
                            eps=_LN_EPS)


def _attend(q, k, v, mask=None):
    """q (B, H, I, D) pre-scaled, k and v (B, J, D) shared by the heads."""
    sim = torch.einsum("bhid,bjd->bhij", q, k).float()
    if mask is not None:
        sim = sim + mask[:, None]
    sim = sim - sim.amax(dim=-1, keepdim=True).detach()
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum("bhij,bjd->bhid", attn.to(v.dtype), v)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


class _CrossAttention(nn.Module):
    """Multi-query cross attention (single-head K / V) with a parallel
    SwiGLU feedforward on the queries."""

    def __init__(self, dim: int, heads: int = 16, dim_head: int = 64,
                 ff_mult: int = 4, **fk):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.norm = _LayerNorm(dim, **fk)
        self.to_q = nn.Linear(dim, heads * dim_head, bias=False, **fk)
        self.to_kv = nn.Linear(dim, 2 * dim_head, bias=False, **fk)
        self.to_out = nn.Linear(heads * dim_head, dim, bias=False, **fk)
        self.ff = nn.ModuleDict({
            "0": nn.Linear(dim, 2 * ff_mult * dim, bias=False, **fk),
            "2": nn.Linear(ff_mult * dim, dim, bias=False, **fk)})

    def forward(self, x, context, mask):
        xn = self.norm(x)
        b, n, _ = x.shape
        q = self.to_q(xn).reshape(b, n, self.heads, self.dim_head)
        q = q.transpose(1, 2) * self.dim_head ** -0.5
        k, v = self.to_kv(context).chunk(2, dim=-1)
        out = self.to_out(_attend(q, k, v, mask))
        a, g = self.ff["0"](xn).chunk(2, dim=-1)
        return out + self.ff["2"](a * F.silu(g))


class _ParallelBlock(nn.Module):
    """PaLM-style parallel attention + feedforward, rotary q / k, single-head
    K / V."""

    def __init__(self, dim: int, heads: int = 16, dim_head: int = 64,
                 ff_mult: int = 4, **fk):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.splits = (heads * dim_head, dim_head, dim_head,
                       2 * ff_mult * dim)
        self.norm = _LayerNorm(dim, **fk)
        self.fused_attn_ff_proj = nn.Linear(dim, sum(self.splits), bias=False,
                                            **fk)
        self.attn_out = nn.Linear(heads * dim_head, dim, bias=False, **fk)
        self.ff_out = nn.ModuleDict({
            "1": nn.Linear(ff_mult * dim, dim, bias=False, **fk)})

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v, ff = self.fused_attn_ff_proj(self.norm(x)).split(
            self.splits, dim=-1)
        pos = torch.arange(n, device=x.device)
        q = _rotary(pos, q.reshape(b, n, self.heads, self.dim_head
                                   ).transpose(1, 2))
        k = _rotary(pos, k)
        out = self.attn_out(_attend(q * self.dim_head ** -0.5, k, v))
        a, g = ff.chunk(2, dim=-1)
        return out + self.ff_out["1"](a * F.silu(g))


class _Residual(nn.Module):
    """The reference's Residual(fn): x + fn(x, ...)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, *args):
        return x + self.fn(x, *args)


class MPSCrossModel(nn.Module):
    """layer_num x [Residual(cross attention), Residual(parallel block)]."""

    def __init__(self, dim: int = 1024, layer_num: int = 4, heads: int = 16,
                 device=None, dtype=torch.float32):
        super().__init__()
        fk = dict(device=resolve_device(device), dtype=dtype)
        self.layers = nn.ModuleList([
            nn.ModuleList([_Residual(_CrossAttention(dim, heads, **fk)),
                           _Residual(_ParallelBlock(dim, heads, **fk))])
            for _ in range(layer_num)])

    def forward(self, image_tokens, text_tokens, mask):
        x = image_tokens
        for cross, block in self.layers:
            x = block(cross(x, text_tokens, mask))
        return x


def mps_condition_mask(text_f, condition_f, threshold: float = 0.01):
    """The prompt-token mask (B, 1, N_text): 0 where a token's largest
    similarity to any condition token exceeds `threshold` of the largest
    in the whole batch (not per sample), else -inf."""
    sim = torch.einsum("bid,bjd->bji", text_f, condition_f)
    sim = sim.amax(dim=1, keepdim=True)
    sim = sim / sim.max()
    return torch.where(sim > threshold, 0.0, float("-inf"))


def mps_score(cross, image_tokens, text_tokens, text_eos, condition_f):
    """-> per-sample reward: cosine of the refined class token and the
    prompt's EOS feature."""
    mask = mps_condition_mask(text_tokens, condition_f)
    mask = mask.expand(image_tokens.shape[0], image_tokens.shape[1],
                       text_tokens.shape[1])
    refined = cross(image_tokens, text_tokens, mask)[:, 0]
    a = refined / torch.linalg.vector_norm(refined, dim=-1, keepdim=True)
    b = text_eos / torch.linalg.vector_norm(text_eos, dim=-1, keepdim=True)
    return torch.sum(a * b, dim=-1)


@dataclasses.dataclass(eq=False)
class MPSReward:
    """Differentiable MPS scorer: CLIP-H per-token features + the cross
    model. (frames, prompts) -> (loss, reward); loss = |reward - max|."""

    model: CLIPModel
    tokenizer: object
    cross: MPSCrossModel
    condition: str = MPS_CONDITION
    num_frames: int = 4
    max_reward: float = 1.0

    def __post_init__(self):
        self.model.requires_grad_(False)
        self.cross.requires_grad_(False)

    @classmethod
    def from_pretrained(cls, clip_path: str, tokenizer, cross_state_dict=None,
                        device=None, **kw):
        if cross_state_dict is None:
            raise ValueError("MPS needs the Cross_model weights "
                             "(MPS_overall.pth state dict)")
        model = CLIPModel.from_pretrained(clip_path, device=device)
        cross = MPSCrossModel(device=model.device)
        cross.load_state_dict(convert_mps_cross_state_dict(cross_state_dict),
                              strict=True)
        return cls(model=model, tokenizer=tokenizer, cross=cross, **kw)

    def _text_tokens(self, prompts: Sequence[str]):
        """Per-token projected text features (B, 77, P) and the EOS row's
        (the largest id's, as the JAX package takes it)."""
        ids, mask = tokenize(self.tokenizer, prompts, max_length=77,
                             device=self.model.device)
        seq = self.model.text_model(ids, mask)[0]
        seq_f = seq @ self.model.text_projection.weight.t()
        eos = seq_f[torch.arange(seq_f.shape[0], device=seq_f.device),
                    ids.argmax(dim=-1)]
        return seq_f, eos

    def _image_tokens(self, pixel_values):
        seq = self.model.vision_model(
            pixel_values.to(self.model.logit_scale.dtype))[0]
        return seq @ self.model.visual_projection.weight.t()

    def __call__(self, frames: torch.Tensor, prompts: Sequence[str],
                 conditions: Optional[Sequence[str]] = None):
        if conditions is None:
            conditions = [self.condition] * len(prompts)
        sub = _subsample(frames, self.num_frames)
        t = sub.shape[1]
        pix = _preprocess(sub, self.model.cfg.vision_config.image_size)
        img = self._image_tokens(pix)
        with torch.no_grad():
            txt, eos = self._text_tokens(prompts)
            cond, _ = self._text_tokens(conditions)
        rep = lambda x: x.repeat_interleave(t, dim=0)
        reward = torch.mean(mps_score(self.cross, img, rep(txt), rep(eos),
                                      rep(cond)))
        return torch.abs(reward - self.max_reward), reward


def convert_mps_cross_state_dict(sd: Mapping) -> Dict[str, torch.Tensor]:
    """Reference Cross_model weights (`cross_model.layers.N.{0,1}.fn.*`, with
    or without the `cross_model.` / `model.cross_model.` prefix; tensors or
    arrays) -> MPSCrossModel's state dict (the weights JAX's converter
    reads; the reference's buffers are dropped)."""
    names = ("0.fn.norm.gamma", "0.fn.to_q.weight", "0.fn.to_kv.weight",
             "0.fn.to_out.weight", "0.fn.ff.0.weight", "0.fn.ff.2.weight",
             "1.fn.norm.gamma", "1.fn.fused_attn_ff_proj.weight",
             "1.fn.attn_out.weight", "1.fn.ff_out.1.weight")

    def find(k):
        for pre in ("cross_model.", "model.cross_model.", ""):
            if pre + k in sd:
                v = sd[pre + k]
                v = v if isinstance(v, torch.Tensor) else np.array(v)
                return torch.as_tensor(v, dtype=torch.float32)
        raise KeyError(k)

    n_layers = 1 + max(int(k.split("layers.")[1].split(".")[0])
                       for k in sd if "layers." in k)
    return {f"layers.{i}.{n}": find(f"layers.{i}.{n}")
            for i in range(n_layers) for n in names}


def mps_cross_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MPSCrossModel tree ({"params": {"cross0": ...}} or
    its inner dict) -> MPSCrossModel's state dict (kernels transposed)."""
    p = params.get("params", params)
    cross = {"norm": "norm.gamma", "to_q": "to_q.weight",
             "to_kv": "to_kv.weight", "to_out": "to_out.weight",
             "ff_in": "ff.0.weight", "ff_out": "ff.2.weight"}
    block = {"norm": "norm.gamma", "fused_proj": "fused_attn_ff_proj.weight",
             "attn_out": "attn_out.weight", "ff_out": "ff_out.1.weight"}
    out = {}
    for name, sub in p.items():
        kind, i = (0, cross) if name.startswith("cross") else (1, block)
        idx = name[len("cross"):] if kind == 0 else name[len("self"):]
        for mod, leaf in sub.items():
            a = np.array(next(iter(leaf.values())), np.float32)
            out[f"layers.{idx}.{kind}.fn.{i[mod]}"] = torch.from_numpy(
                np.ascontiguousarray(a if a.ndim == 1 else a.T))
    return out
