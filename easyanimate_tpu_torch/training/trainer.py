"""SFT train step for the MMDiT (flow matching) on one device.

Parity: easyanimate_tpu/training/trainer.py (reference accelerate +
DeepSpeed loop, train.py:1649-2207). Carried over:
  - LR schedules with warmup, counted in optimizer updates as optax counts
    them (train.py:1504-1510)
  - trainable-module filter + dual learning rate by substring match over
    parameter names: names containing a `trainable_modules` entry train at
    lr, `trainable_modules_low_lr` at lr/2, the rest are frozen
    (train.py:1090-1094, 1207-1251); the port's names are the reference's
    own state-dict keys
  - frozen gradients zeroed before the clip, fixed or adaptive global-norm
    clip (train.py:2116-2137), AdamW with a weight-decay mask, gradient
    accumulation as optax.MultiSteps (train.py:881-886), EMA.

Precision: the JAX parameters are float32 and are cast to the compute
dtype at use. The port's modules hold the compute dtype (bf16 at 12B), so
create_train_state keeps float32 master copies and float32 Adam moments,
and each step copies the updated masters back into the modules. The
gradient of a bf16 parameter, cast to float32, is the gradient JAX takes
with respect to its float32 parameter.

The step takes latents + text embeddings (VAE and text encoding happen
before it). Random draws come from a torch.Generator, or are handed in
(`draws`) so that a test can give both packages the same numbers.
Still to port (ROADMAP queue 1 item 10): the 'came' and 'adamw8bit'
optimizers, and the 'ddpm' / 'sigma' losses with utils/diffusion.py.
"""
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import torch
from torch import nn

from . import optim
from .losses import (FlowMatchLossConfig, flow_noise_and_target,
                     masked_mse_loss, sample_flow_sigmas, with_motion_sub_loss)

_NOT_PORTED = "not ported yet (ROADMAP.md, queue 1 item 10)"


@dataclasses.dataclass
class TrainState:
    step: int
    params: Dict[str, torch.Tensor]  # float32, by parameter name
    opt_state: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 3e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-10
    max_grad_norm: float = 0.05
    ema_decay: float = 0.9999
    use_ema: bool = False
    # 'flow' (V5.1); 'ddpm' and 'sigma' are not ported yet
    loss_type: str = "flow"
    loss: FlowMatchLossConfig = dataclasses.field(default_factory=FlowMatchLossConfig)
    # 'adamw'; 'came' and 'adamw8bit' are not ported yet
    optimizer: str = "adamw"
    # LR schedule (train.py:1504-1510): 'constant' | 'linear' | 'cosine'
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 10_000  # schedule horizon
    gradient_accumulation_steps: int = 1
    # substring match over parameter names; None = train everything
    trainable_modules: Optional[Sequence[str]] = None
    trainable_modules_low_lr: Sequence[str] = ()
    # adaptive clip (train.py:2116-2137); False = fixed clip_by_global_norm
    adaptive_grad_clip: bool = False
    initial_grad_norm_ratio: float = 5.0
    abnormal_norm_clip_start: int = 1000
    # motion sub-loss on temporal deltas (train.py:704-707, 2078-2082)
    motion_sub_loss: bool = False
    motion_sub_loss_ratio: float = 0.25


class FlowDraws(NamedTuple):
    """The random inputs of one flow-matching step."""
    sigmas: torch.Tensor     # [B] float32
    timesteps: torch.Tensor  # [B] float32
    noise: torch.Tensor      # latents' shape, float32


# -- schedules ---------------------------------------------------------------


def _linear(init: float, end: float, steps: int) -> optim.Schedule:
    if steps <= 0:  # optax: a constant schedule at init
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _join(schedules, boundary: int) -> optim.Schedule:
    first, second = schedules
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(cfg: TrainConfig) -> optim.Schedule:
    """count (optimizer updates) -> learning rate, as optax's constant /
    join(linear warmup, linear decay) / warmup_cosine_decay schedules.
    Under gradient accumulation the micro-step counts divide by k."""
    base = cfg.learning_rate
    k = max(cfg.gradient_accumulation_steps, 1)
    warm = cfg.lr_warmup_steps // k
    total = max(cfg.max_train_steps // k, warm + 1)
    if cfg.lr_scheduler == "constant":
        if warm == 0:
            return lambda count: base
        return _join((_linear(0.0, base, warm), lambda count: base), warm)
    if cfg.lr_scheduler == "linear":
        return _join((_linear(0.0, base, warm),
                      _linear(base, 0.0, total - warm)), warm)
    if cfg.lr_scheduler == "cosine":
        decay = total - warm

        def cosine(count):
            return base * 0.5 * (1 + math.cos(math.pi * min(count, decay) / decay))

        return _join((_linear(0.0, base, warm), cosine), warm)
    raise ValueError(f"unknown lr_scheduler {cfg.lr_scheduler!r}")


# -- adaptive clip (reference train.py:2116-2137) ----------------------------


def adaptive_clip_by_global_norm(max_grad_norm: float, initial_ratio: float,
                                 decay_steps: int) -> optim.GradientTransformation:
    """torch clip_grad_norm_ with the reference's decaying/abnormal rules.

    threshold(step) decays linearly from initial_ratio*max_grad_norm to
    max_grad_norm over decay_steps; once step > decay_steps, a gradient norm
    exceeding 5x the threshold is clipped to threshold/min(norm/threshold,10).
    """
    def update(updates, step, params=None):
        frac = min(max(step / max(decay_steps, 1), 0.0), 1.0)
        thresh = (initial_ratio + (1.0 - initial_ratio) * frac) * max_grad_norm
        norm = optim.global_norm(updates)
        ratio = norm / thresh
        actual = torch.where((ratio > 5.0) & (step > decay_steps),
                             thresh / torch.clamp(ratio, max=10.0),
                             torch.full_like(norm, thresh))
        scale = torch.clamp(actual / (norm + 1e-12), max=1.0)
        return {k: g * scale for k, g in updates.items()}, step + 1

    return optim.GradientTransformation(lambda params: 0, update)


# -- trainable filter + dual LR ----------------------------------------------


def lr_multiplier_tree(names: Iterable[str], cfg: TrainConfig) -> Dict[str, float]:
    """1.0 for trainable, 0.5 for low-lr modules, 0.0 for frozen, by name.

    The reference's substring semantics (trainer.py:160-183 of the JAX
    package): a name containing a trainable_modules entry trains at full
    lr, one matching only trainable_modules_low_lr at lr/2, the rest are
    frozen. trainable_modules None (and no low-lr list) trains everything."""
    names = list(names)
    high, low = cfg.trainable_modules, tuple(cfg.trainable_modules_low_lr)
    if high is None and not low:
        return dict.fromkeys(names, 1.0)
    high = tuple(high or ())
    return {n: 1.0 if any(m in n for m in high)
            else 0.5 if any(m in n for m in low) else 0.0 for n in names}


def make_optimizer(cfg: TrainConfig, names: Optional[Iterable[str]] = None
                   ) -> optim.GradientTransformation:
    """The optimizer chain; `names` (the parameter names) is needed
    whenever a trainable filter or dual LR is configured."""
    mult = None
    if cfg.trainable_modules is not None or cfg.trainable_modules_low_lr:
        if names is None:
            raise ValueError("trainable-module filtering needs parameter names")
        mult = lr_multiplier_tree(names, cfg)
    if cfg.optimizer in ("came", "adamw8bit"):
        raise NotImplementedError(f"optimizer {cfg.optimizer!r} is {_NOT_PORTED}")
    if cfg.optimizer != "adamw":
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    parts = []
    if mult is not None:
        # zero frozen grads BEFORE the clip, so the global norm is over the
        # trainable parameters only (train.py:2118)
        parts.append(optim.scale_by_name(
            {n: 1.0 if m > 0 else 0.0 for n, m in mult.items()}))
    if cfg.adaptive_grad_clip:
        parts.append(adaptive_clip_by_global_norm(
            cfg.max_grad_norm, cfg.initial_grad_norm_ratio,
            cfg.abnormal_norm_clip_start))
    else:
        parts.append(optim.clip_by_global_norm(cfg.max_grad_norm))
    parts.append(optim.scale_by_adam(cfg.adam_b1, cfg.adam_b2, cfg.adam_eps))
    if cfg.weight_decay:
        parts.append(optim.add_decayed_weights(
            cfg.weight_decay,
            None if mult is None else {n: m > 0 for n, m in mult.items()}))
    if mult is not None:
        # dual LR: low-lr modules step at lr/2, frozen ones at 0 (again:
        # weight decay must not move them either)
        parts.append(optim.scale_by_name(mult))
    parts.append(optim.scale_by_learning_rate(make_lr_schedule(cfg)))
    tx = optim.chain(*parts)
    if cfg.gradient_accumulation_steps > 1:
        tx = optim.multi_steps(tx, cfg.gradient_accumulation_steps)
    return tx


# -- state, loss, step -------------------------------------------------------


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """float32 master copies of every parameter, optimizer state, EMA."""
    params = {n: p.detach().float().clone() for n, p in model.named_parameters()}
    tx = make_optimizer(cfg, params)
    return TrainState(
        step=0, params=params, opt_state=tx.init(params),
        ema_params=({n: p.clone() for n, p in params.items()}
                    if cfg.use_ema else None))


def draw_flow_inputs(generator: Optional[torch.Generator],
                     latents: torch.Tensor, cfg: FlowMatchLossConfig) -> FlowDraws:
    """sigmas and timesteps (sample_flow_sigmas), then N(0, 1) noise."""
    sigmas, timesteps = sample_flow_sigmas(generator, latents.shape[0], cfg,
                                           latents.device)
    noise = torch.randn(latents.shape, generator=generator,
                        device=latents.device)
    return FlowDraws(sigmas, timesteps, noise)


def flow_prediction(model: nn.Module, batch: Dict[str, Any], draws: FlowDraws):
    """(pred, target): the model on the noised latents, and eps - x0."""
    noisy, target = flow_noise_and_target(batch["latents"], draws.noise,
                                          draws.sigmas)
    pred = model(noisy, draws.timesteps, batch["text"], batch.get("rope"))
    return pred, target


def make_loss_fn(model: nn.Module, cfg: TrainConfig) -> Callable:
    """loss_fn(batch, draws) -> (loss, metrics) for cfg.loss_type, with the
    model's current parameters. batch: latents (B, C, T, H, W), text
    (B, S, D), optional rope (cos, sin)."""
    if cfg.loss_type in ("ddpm", "sigma"):
        raise NotImplementedError(f"loss_type {cfg.loss_type!r} is {_NOT_PORTED}")
    if cfg.loss_type != "flow":
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")

    def loss_fn(batch, draws: FlowDraws):
        pred, target = flow_prediction(model, batch, draws)
        loss = masked_mse_loss(pred, target, cfg.loss.loss_outlier_threshold)
        if cfg.motion_sub_loss:
            loss = with_motion_sub_loss(loss, pred, target,
                                        cfg.motion_sub_loss_ratio)
        return loss, {"loss": loss.detach(), "mean_sigma": draws.sigmas.mean()}

    return loss_fn


def _grads(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(p.shape, device=p.device) if p.grad is None
            else p.grad.float() for n, p in named.items()}


def make_train_step(model: nn.Module, cfg: TrainConfig) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) ->
    (state, metrics). One forward + backward through the model, the
    optimizer update on the float32 masters (in place), EMA, and the
    masters copied back into the model's parameters."""
    named = dict(model.named_parameters())
    tx = make_optimizer(cfg, named)
    loss_fn = make_loss_fn(model, cfg)

    def step(state: TrainState, batch, generator=None, draws=None):
        if draws is None:
            draws = draw_flow_inputs(generator, batch["latents"], cfg.loss)
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(batch, draws)
        loss.backward()
        grads = _grads(named)
        model.zero_grad(set_to_none=True)
        metrics["grad_norm"] = optim.global_norm(grads)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        del grads
        optim.apply_updates(state.params, updates)
        del updates
        ema = state.ema_params
        with torch.no_grad():
            if ema is not None:
                d = cfg.ema_decay
                for n, e in ema.items():
                    e.mul_(d).add_(state.params[n], alpha=1 - d)
            for n, p in named.items():
                p.copy_(state.params[n])
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return step


def make_param_grad_norms(model: nn.Module, cfg: TrainConfig) -> Callable:
    """Per-parameter grad-norm reporter for abnormal-norm steps (reference
    report_model_info, train.py:2128-2137). Returns fn(batch, draws) ->
    {name: norm}; one extra forward + backward on the steps it is called."""
    loss_fn = make_loss_fn(model, cfg)
    named = dict(model.named_parameters())

    def norms(batch, draws: FlowDraws):
        model.zero_grad(set_to_none=True)
        loss_fn(batch, draws)[0].backward()
        out = {n: g.norm() for n, g in _grads(named).items()}
        model.zero_grad(set_to_none=True)
        return out

    return norms
