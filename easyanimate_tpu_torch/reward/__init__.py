"""Differentiable reward models (CLIP score, HPS, PickScore, aesthetic, MPS)
for reward-backprop training."""
from .reward_fn import (
    AestheticReward,
    CLIPScoreReward,
    HPSReward,
    PickScoreReward,
)

__all__ = [
    "AestheticReward",
    "CLIPScoreReward",
    "HPSReward",
    "PickScoreReward",
]
