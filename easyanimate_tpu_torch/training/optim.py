"""Gradient transformations over {name: tensor} dicts, the optax pieces the
JAX trainer chains (easyanimate_tpu/training/trainer.py::make_optimizer):
clip_by_global_norm, scale_by_adam, add_decayed_weights,
scale_by_learning_rate, a per-name scale, chain and MultiSteps, with the
same formulas and counters as optax 0.2.

Each transformation is an (init, update) pair: init(params) -> state;
update(updates, state, params) -> (updates, state). Updates are new
tensors; optimizer state (Adam moments, accumulated gradients) is updated
in place to keep one copy of it, and apply_updates adds the updates into
the parameters in place. Counters are Python ints, so no step reads a
value back from the device except the clip, whose condition is a tensor.
"""
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], Any]
    update: Callable[..., Tuple[Params, Any]]


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tree.values()))


def _stateless(fn: Callable[[Params], Params]) -> GradientTransformation:
    return GradientTransformation(lambda params: (),
                                  lambda updates, state, params=None:
                                  (fn(updates), state))


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def scale_by_name(mult: Dict[str, float]) -> GradientTransformation:
    """Stateless per-name scaling (the trainer's freeze and dual LR)."""
    return _stateless(lambda u: {k: g if mult[k] == 1.0 else g * mult[k]
                                 for k, g in u.items()})


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: t if norm < max_norm else t / norm * max."""
    def clip(updates):
        norm = global_norm(updates)
        keep = norm < max_norm
        return {k: torch.where(keep, g, g / norm * max_norm)
                for k, g in updates.items()}

    return _stateless(clip)


class AdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0): float32 moments, bias-corrected
    mu_hat / (sqrt(nu_hat) + eps)."""
    def init(params):
        return AdamState(0, {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.items()},
                         {k: torch.zeros_like(p, dtype=torch.float32)
                          for k, p in params.items()})

    def update(updates, state, params=None):
        count = state.count + 1
        bc1, bc2 = 1 - b1 ** count, 1 - b2 ** count
        out = {}
        for k, g in updates.items():
            mu, nu = state.mu[k], state.nu[k]
            mu.mul_(b1).add_(g, alpha=1 - b1)
            nu.mul_(b2).addcmul_(g, g, value=1 - b2)
            out[k] = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        return out, AdamState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def add_decayed_weights(weight_decay: float,
                        mask: Optional[Dict[str, bool]] = None
                        ) -> GradientTransformation:
    """optax.add_decayed_weights: u + wd * p where mask (all if None)."""
    def update(updates, state, params=None):
        return {k: g + weight_decay * params[k]
                if mask is None or mask[k] else g
                for k, g in updates.items()}, state

    return GradientTransformation(lambda params: (), update)


def scale_by_learning_rate(schedule: Schedule) -> GradientTransformation:
    """optax.scale_by_learning_rate: u * -schedule(count), count from 0."""
    def update(updates, count, params=None):
        lr = schedule(count)
        return {k: g * -lr for k, g in updates.items()}, count + 1

    return GradientTransformation(lambda params: 0, update)


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner: Any
    acc: Params


def multi_steps(inner: GradientTransformation, k: int
                ) -> GradientTransformation:
    """optax.MultiSteps(every_k_schedule=k): accumulate the running mean of
    k micro-step gradients; every k-th call applies the inner
    transformation to the mean, the others return zero updates."""
    def init(params):
        return MultiStepsState(0, 0, inner.init(params),
                               {n: torch.zeros_like(p, dtype=torch.float32)
                                for n, p in params.items()})

    def update(updates, state, params=None):
        for n, g in updates.items():
            acc = state.acc[n]
            acc.add_((g - acc) / (state.mini_step + 1))
        if state.mini_step < k - 1:
            return ({n: torch.zeros_like(g) for n, g in updates.items()},
                    state._replace(mini_step=state.mini_step + 1))
        out, inner_state = inner.update(state.acc, state.inner, params)
        out = {n: u.clone() for n, u in out.items()}  # acc is reset below
        for acc in state.acc.values():
            acc.zero_()
        return out, MultiStepsState(0, state.gradient_step + 1, inner_state,
                                    state.acc)

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))
