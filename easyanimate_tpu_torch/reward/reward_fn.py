"""Differentiable reward models for reward-backprop training.

Parity: easyanimate_tpu/reward/reward_fn.py (reference
easyanimate/reward/reward_fn.py: AestheticReward :30, HPSReward :99,
PickScoreReward :193). Each scorer maps (frames, prompts) -> (loss,
reward) and is differentiable with respect to the frames, so the sampler
trains through it; its own weights are frozen.

`frames`: (B, T, H, W, C) float in [0, 1]. A uniform subset of frames
(indices linspace(0, T - 1, n) truncated to int) is resized to a square
`image_size` (bilinear, half-pixel centres, no antialias: jax.image.resize
with antialias=False) and CLIP-normalised. HPS and PickScore are CLIP
image-text similarity with their fine-tuned weights; the aesthetic score
is an MLP head over normalised image embeddings, with a ReLU between its
layers as the JAX package has it.
"""
import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .clip import CLIPModel, tokenize

_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _preprocess(frames: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, C) in [0, 1] -> (B * T, C, size, size) CLIP-normalised."""
    b, t, h, w, c = frames.shape
    x = frames.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=False)
    mean = torch.tensor(_CLIP_MEAN, device=x.device).view(1, c, 1, 1)
    std = torch.tensor(_CLIP_STD, device=x.device).view(1, c, 1, 1)
    return (x - mean) / std


def _subsample(frames: torch.Tensor, num: int) -> torch.Tensor:
    t = frames.shape[1]
    idx = torch.linspace(0, t - 1, min(num, t)).long()
    return frames[:, idx.to(frames.device)]


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


@dataclasses.dataclass(eq=False)
class CLIPScoreReward:
    """CLIP image-text cosine similarity times exp(logit_scale); the base of
    HPS and PickScore (the same computation with fine-tuned weights)."""

    model: CLIPModel
    tokenizer: object
    num_frames: int = 4

    def __post_init__(self):
        self.model.requires_grad_(False)

    @classmethod
    def from_pretrained(cls, path: str, tokenizer, device=None, **kw):
        """A Hugging Face CLIP directory on `device` (the card by default);
        `tokenizer` is the caller's (see reward/clip.py)."""
        return cls(model=CLIPModel.from_pretrained(path, device=device),
                   tokenizer=tokenizer, **kw)

    def _text_features(self, prompts: Sequence[str]) -> torch.Tensor:
        ids, mask = tokenize(self.tokenizer, prompts, device=self.model.device)
        return _unit(self.model.get_text_features(ids, mask))

    def __call__(self, frames: torch.Tensor, prompts: Sequence[str]):
        """-> (loss, reward); loss = -reward. The text features of every
        prompt broadcast against the image features (B * T rows)."""
        sub = _subsample(frames, self.num_frames)
        t = sub.shape[1]
        pix = _preprocess(sub, self.model.cfg.vision_config.image_size)
        img = _unit(self.model.get_image_features(pix))
        with torch.no_grad():
            txt = self._text_features(prompts).repeat_interleave(t, dim=0)
        scale = torch.exp(self.model.logit_scale)
        reward = torch.mean(torch.sum(img * txt, dim=-1) * scale)
        return -reward, reward


class HPSReward(CLIPScoreReward):
    """Human Preference Score v2 / v2.1: a CLIP-H fine-tune, same scoring."""


class PickScoreReward(CLIPScoreReward):
    """PickScore: a CLIP-H fine-tune scoring image-text preference."""


@dataclasses.dataclass(eq=False)
class AestheticReward:
    """CLIP image embeddings + an MLP aesthetic head (reference
    reward_fn.py:30-97 + the improved-aesthetic-predictor weights).
    head_params: {"w0": (in, out), "b0": (out,), ...} on the model's
    device, convert_aesthetic_head's layout."""

    model: CLIPModel
    head_params: Dict[str, torch.Tensor]
    num_frames: int = 4

    def __post_init__(self):
        self.model.requires_grad_(False)

    @classmethod
    def from_pretrained(cls, clip_path: str, head_state_dict=None,
                        device=None, **kw):
        if not head_state_dict:
            raise ValueError("aesthetic head weights required "
                             "(improved-aesthetic-predictor linear stack)")
        model = CLIPModel.from_pretrained(clip_path, device=device)
        return cls(model=model, head_params=convert_aesthetic_head(
            head_state_dict, device=model.device), **kw)

    def __call__(self, frames: torch.Tensor, prompts=None):
        sub = _subsample(frames, self.num_frames)
        pix = _preprocess(sub, self.model.cfg.vision_config.image_size)
        h = _unit(self.model.get_image_features(pix))
        n_layers = len([k for k in self.head_params if k.startswith("w")])
        for i in range(n_layers):
            h = h @ self.head_params[f"w{i}"] + self.head_params[f"b{i}"]
            if i < n_layers - 1:
                h = F.relu(h)
        reward = torch.mean(h)
        return -reward, reward


def convert_aesthetic_head(sd: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """Reference improved-aesthetic-predictor `layers.N.{weight,bias}` (torch
    tensors or arrays) -> {"w0": weight.T, "b0": bias, ...} float32, in
    layer order; also takes the JAX package's head params
    ({"w0": (in, out), ...}) as they are."""
    def f32(v):
        v = v if isinstance(v, torch.Tensor) else np.array(v)
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    if all(k[0] in "wb" and k[1:].isdigit() for k in sd):
        return {k: f32(v) for k, v in sd.items()}
    out = {}
    i = 0
    for k in sorted(sd, key=lambda s: int(s.split(".")[1])):
        v = f32(sd[k])
        if k.endswith("weight"):
            out[f"w{i}"] = v.t().contiguous()
        elif k.endswith("bias"):
            out[f"b{i}"] = v
            i += 1
    return out


def MPSReward(*args, **kw):
    """The MPS scorer lives in mps.py; kept here for the reference's import
    location."""
    from .mps import MPSReward as _MPS

    return _MPS(*args, **kw)
