"""SFT train step for the MMDiT (flow matching), on one device or over a
mesh (ZeRO-2 / FSDP2 and sequence parallelism: make_train_step's
docstring, parallel/sharding.py).

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
    clip (train.py:2116-2137), AdamW with a weight-decay mask, CAME and
    8-bit AdamW (train.py:1186-1203), gradient accumulation as
    optax.MultiSteps (train.py:881-886), EMA
  - the flow-matching loss and the DDPM-family 'ddpm' / 'sigma' losses
    (train.py:938-942, 2022-2076) through utils/diffusion.py.

Precision: the JAX parameters are float32 and are cast to the compute
dtype at use. The port's modules hold the compute dtype (bf16 at 12B), so
create_train_state keeps float32 master copies and float32 Adam moments,
and each step copies the updated masters back into the modules. The
gradient of a bf16 parameter, cast to float32, is the gradient JAX takes
with respect to its float32 parameter.

The step takes latents + text embeddings (VAE and text encoding happen
before it), V5's second text stream (`text_t5`), and the inpaint /
control latents of the -InP and -Control models. Random draws come from a
torch.Generator, or are handed in (`draws`) so that a test can give both
packages the same numbers.
"""
import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..parallel.context import sequence_parallel
from ..parallel.mesh import Mesh
from ..parallel.sharding import ZeroShards
from ..pipeline.schedulers import DDIMConfig
from ..utils.diffusion import GaussianDiffusion
from . import optim
from .adam8bit import scale_by_adam8bit
from .came import came
from .losses import (FlowMatchLossConfig, ddpm_sample_timesteps,
                     flow_noise_and_target, masked_mse_loss,
                     sample_flow_sigmas, with_motion_sub_loss)



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
    # 'flow' (V5.1), 'ddpm' (plain eps MSE), 'sigma' (IDDPM learned-range VB)
    loss_type: str = "flow"
    loss: FlowMatchLossConfig = dataclasses.field(default_factory=FlowMatchLossConfig)
    # optimizer family: 'adamw' | 'came' | 'adamw8bit' (train.py:1186-1203)
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


class DDPMDraws(NamedTuple):
    """The random inputs of one 'ddpm' / 'sigma' step."""
    timesteps: torch.Tensor  # [B] integer
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
                                 decay_steps: int,
                                 norm_fn: Callable = optim.global_norm
                                 ) -> optim.GradientTransformation:
    """torch clip_grad_norm_ with the reference's decaying/abnormal rules.

    threshold(step) decays linearly from initial_ratio*max_grad_norm to
    max_grad_norm over decay_steps; once step > decay_steps, a gradient norm
    exceeding 5x the threshold is clipped to threshold/min(norm/threshold,10).
    """
    def update(updates, step, params=None):
        frac = min(max(step / max(decay_steps, 1), 0.0), 1.0)
        thresh = (initial_ratio + (1.0 - initial_ratio) * frac) * max_grad_norm
        norm = norm_fn(updates)
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


def make_optimizer(cfg: TrainConfig, names: Optional[Iterable[str]] = None,
                   norm_fn: Callable = optim.global_norm
                   ) -> optim.GradientTransformation:
    """The optimizer chain; `names` (the parameter names) is needed
    whenever a trainable filter or dual LR is configured. `norm_fn` is the
    clips' global norm (ZeroShards.global_norm when the tree holds this
    rank's chunks)."""
    mult = None
    if cfg.trainable_modules is not None or cfg.trainable_modules_low_lr:
        if names is None:
            raise ValueError("trainable-module filtering needs parameter names")
        mult = lr_multiplier_tree(names, cfg)
    if cfg.optimizer not in ("adamw", "came", "adamw8bit"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")

    schedule = make_lr_schedule(cfg)
    parts = []
    if mult is not None:
        # zero frozen grads BEFORE the clip, so the global norm is over the
        # trainable parameters only (train.py:2118)
        parts.append(optim.scale_by_name(
            {n: 1.0 if m > 0 else 0.0 for n, m in mult.items()}))
    if cfg.adaptive_grad_clip:
        parts.append(adaptive_clip_by_global_norm(
            cfg.max_grad_norm, cfg.initial_grad_norm_ratio,
            cfg.abnormal_norm_clip_start, norm_fn))
    else:
        parts.append(optim.clip_by_global_norm(cfg.max_grad_norm, norm_fn))
    if cfg.optimizer == "came":
        # came(1.0) emits already-negated unit-lr updates (the reference
        # passes CAME no weight decay, train.py:1195-1203): multiply by +lr
        parts.append(came(1.0))
        if mult is not None:
            parts.append(optim.scale_by_name(mult))
        parts.append(optim.scale_by_schedule(schedule))
        return _accumulate(optim.chain(*parts), cfg)
    if cfg.optimizer == "adamw8bit":
        parts.append(scale_by_adam8bit(cfg.adam_b1, cfg.adam_b2,
                                       max(cfg.adam_eps, 1e-8)))
    else:
        parts.append(optim.scale_by_adam(cfg.adam_b1, cfg.adam_b2,
                                         cfg.adam_eps))
    if cfg.weight_decay:
        parts.append(optim.add_decayed_weights(
            cfg.weight_decay,
            None if mult is None else {n: m > 0 for n, m in mult.items()}))
    if mult is not None:
        # dual LR: low-lr modules step at lr/2, frozen ones at 0 (again:
        # weight decay must not move them either)
        parts.append(optim.scale_by_name(mult))
    parts.append(optim.scale_by_learning_rate(schedule))
    return _accumulate(optim.chain(*parts), cfg)


def _accumulate(tx: optim.GradientTransformation, cfg: TrainConfig
                ) -> optim.GradientTransformation:
    if cfg.gradient_accumulation_steps > 1:
        tx = optim.multi_steps(tx, cfg.gradient_accumulation_steps)
    return tx


# -- state, loss, step -------------------------------------------------------


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """float32 master copies of every parameter, optimizer state, EMA.
    Under a mesh, this rank's chunks of them (ZeRO-2, or FSDP's chunks
    when fsdp_shard ran on the model: parallel/sharding.py)."""
    named = dict(model.named_parameters())
    if mesh is None:
        params = {n: p.detach().float().clone() for n, p in named.items()}
    else:
        _check_sharded_optimizer(cfg)
        params = ZeroShards(named, mesh).masters(named)
    tx = make_optimizer(cfg, params)
    return TrainState(
        step=0, params=params, opt_state=tx.init(params),
        ema_params=({n: p.clone() for n, p in params.items()}
                    if cfg.use_ema else None))


def _check_sharded_optimizer(cfg: TrainConfig) -> None:
    """ZeRO-2 / FSDP chunk the state elementwise: CAME's factored row and
    column statistics and 8-bit Adam's blocks do not chunk so."""
    if cfg.optimizer != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} under a mesh (ZeRO-2 / FSDP) is "
            "not ported (ROADMAP queue 1 item 10: multi-GPU); use adamw")


def draw_flow_inputs(generator: Optional[torch.Generator],
                     latents: torch.Tensor, cfg: FlowMatchLossConfig) -> FlowDraws:
    """sigmas and timesteps (sample_flow_sigmas), then N(0, 1) noise."""
    sigmas, timesteps = sample_flow_sigmas(generator, latents.shape[0], cfg,
                                           latents.device)
    noise = torch.randn(latents.shape, generator=generator,
                        device=latents.device)
    return FlowDraws(sigmas, timesteps, noise)


def draw_inputs(generator: Optional[torch.Generator], latents: torch.Tensor,
                cfg: TrainConfig):
    """The draws of one step of cfg.loss_type: FlowDraws, or DDPMDraws
    (ddpm_sample_timesteps, then N(0, 1) noise)."""
    if cfg.loss_type == "flow":
        return draw_flow_inputs(generator, latents, cfg.loss)
    t = ddpm_sample_timesteps(generator, latents.shape[0],
                              cfg.loss.num_train_timesteps,
                              cfg.loss.uniform_bands, latents.device)
    return DDPMDraws(t, torch.randn(latents.shape, generator=generator,
                                    device=latents.device))


def apply_model(model: nn.Module, noisy: torch.Tensor,
                timesteps: torch.Tensor, batch: Dict[str, Any]):
    """The model on the noised latents with the batch's text (and V5's
    `text_t5`), RoPE and conditioning (inpaint / control latents), as the
    JAX loss applies it (easyanimate_tpu/training/trainer.py:281-288). The
    LoRA step applies it too (JAX lora.py:126-131)."""
    return model(noisy, timesteps, batch["text"], batch.get("rope"),
                 encoder_hidden_states_t5=batch.get("text_t5"),
                 inpaint_latents=batch.get("inpaint_latents"),
                 control_latents=batch.get("control_latents"))


def flow_prediction(model: nn.Module, batch: Dict[str, Any], draws: FlowDraws):
    """(pred, target): the model on the noised latents, and eps - x0."""
    noisy, target = flow_noise_and_target(batch["latents"], draws.noise,
                                          draws.sigmas)
    return apply_model(model, noisy, draws.timesteps, batch), target


def make_loss_fn(model: nn.Module, cfg: TrainConfig) -> Callable:
    """loss_fn(batch, draws) -> (loss, metrics) for cfg.loss_type, with the
    model's current parameters. batch: latents (B, C, T, H, W), text
    (B, S, D), optional text_t5 (B, S_t5, D_t5), rope (cos, sin),
    inpaint_latents and control_latents; draws: FlowDraws ('flow') or
    DDPMDraws."""
    if cfg.loss_type not in ("flow", "ddpm", "sigma"):
        raise ValueError(f"unknown loss_type {cfg.loss_type!r}")
    if cfg.loss_type != "flow":
        gd = GaussianDiffusion.from_config(DDIMConfig(
            num_train_timesteps=cfg.loss.num_train_timesteps))

        def ddpm_loss(batch, draws: DDPMDraws):
            return gd.training_losses(
                lambda xt, t: apply_model(model, xt, t.float(), batch),
                batch["latents"], draws.timesteps, draws.noise,
                learn_sigma=cfg.loss_type == "sigma")

        return ddpm_loss

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


def make_train_step(model: nn.Module, cfg: TrainConfig,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) ->
    (state, metrics). One forward + backward through the model, the
    optimizer update on the float32 masters (in place), EMA, and the
    masters copied back into the model's parameters.

    Under a mesh (state from create_train_state(model, cfg, mesh)): the
    batch and draws are this rank's dp rows; with sp > 1 the model runs
    inside sequence_parallel(mesh, "allgather") (JAX shards the same
    tokens through data_spec), every sp rank computing the loss over all
    tokens of its rows. The gradient is the mean over dp, reduce-
    scattered into this rank's chunks (ZeRO-2; FSDP's own reduce-scatter
    with fsdp_shard), the optimizer and EMA run on the chunks, and the
    updated chunks are all-gathered into the parameters. The reported
    loss is the mean over dp."""
    named = dict(model.named_parameters())
    shards = None if mesh is None else ZeroShards(named, mesh)
    if shards is not None:
        _check_sharded_optimizer(cfg)
    tx = make_optimizer(cfg, named, optim.global_norm if shards is None
                        else shards.global_norm)
    loss_fn = make_loss_fn(model, cfg)

    def forward_backward(batch, draws):
        loss, metrics = loss_fn(batch, draws)
        (loss if shards is None or shards.loss_scale == 1.0
         else loss * shards.loss_scale).backward()
        return metrics

    def step(state: TrainState, batch, generator=None, draws=None):
        if draws is None:
            draws = draw_inputs(generator, batch["latents"], cfg)
        model.zero_grad(set_to_none=True)
        if mesh is None:
            metrics = forward_backward(batch, draws)
            grads = _grads(named)
        else:
            with sequence_parallel(mesh, "allgather"):
                metrics = forward_backward(batch, draws)
            grads = shards.grads(named)
            for k in ("loss", "mean_sigma"):
                if k in metrics:
                    metrics[k] = dp_mean(metrics[k], mesh)
        model.zero_grad(set_to_none=True)
        metrics["grad_norm"] = (optim.global_norm(grads) if shards is None
                                else shards.global_norm(grads))
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
            if shards is None:
                for n, p in named.items():
                    p.copy_(state.params[n])
            else:
                shards.write_params(named, state.params)
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return step


def dp_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the dp ranks of a 0-d metric (the sp peers agree)."""
    x = x.detach().float().clone()
    if mesh.shape["dp"] > 1:
        dist.all_reduce(x, group=mesh.group("dp"))
        x /= mesh.shape["dp"]
    return x


def make_param_grad_norms(model: nn.Module, cfg: TrainConfig) -> Callable:
    """Per-parameter grad-norm reporter for abnormal-norm steps (reference
    report_model_info, train.py:2128-2137). Returns fn(batch, draws) ->
    {name: norm}; one extra forward + backward on the steps it is called."""
    loss_fn = make_loss_fn(model, cfg)
    named = dict(model.named_parameters())

    def norms(batch, draws):
        model.zero_grad(set_to_none=True)
        loss_fn(batch, draws)[0].backward()
        out = {n: g.norm() for n, g in _grads(named).items()}
        model.zero_grad(set_to_none=True)
        return out

    return norms
