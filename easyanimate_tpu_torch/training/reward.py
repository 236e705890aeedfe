"""Reward backpropagation (DRaFT / DRTune) for LoRA fine-tuning.

Parity: easyanimate_tpu/training/reward.py (reference
scripts/train_reward_lora.py: the sampling loop inside autograd
:1515-1560; gradients only through the steps a strategy selects
:1496-1512; DRTune detaches the latent input of those steps :1527-1530;
only the first `num_decoded_latents` latent frames are decoded, with a
rematerialised VAE decode, :1147-1154, 1564-1573, and scored by a
differentiable reward).

The JAX step routes each step's prediction through lax.cond(selected,
identity, stop_gradient); the port runs a step that is not selected under
torch.no_grad(), so it costs no transformer backward, while the latent
carry `lat + (sigma_next - sigma) * pred` stays outside it and keeps its
identity path. The FlowMatch schedule takes mu = 1.0; CFG is batched as
[negative, text], the negative text being zeros by default (JAX's
reward.py:84). The LoRA hooks stay attached over the whole forward and
backward: the selected steps' remat backward recomputes their blocks.

A reward function maps frames (B, T, H, W, C) float32 in [0, 1] to a
reward per sample (or one value); the loss is -mean(reward).
"""
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..models.vae import vae_decode
from ..pipeline.schedulers import FlowMatchEulerConfig, flow_match_schedule
from . import optim
from .lora import LoRAConfig, attach_lora, flatten_lora, lora_init
from .trainer import TrainConfig, TrainState, make_optimizer


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    num_sample_steps: int = 50
    backprop_strategy: str = "last"   # 'last' | 'tail' | 'uniform' | 'random'
    backprop_num_steps: int = 5
    stop_latent_model_input_gradient: bool = False  # DRTune
    num_decoded_latents: int = 1
    guidance_scale: float = 6.0


def backprop_step_mask(cfg: RewardConfig,
                       generator: Optional[torch.Generator] = None,
                       start: Optional[int] = None) -> torch.Tensor:
    """bool[num_sample_steps] on the CPU; True = gradient flows through
    that step. 'random' selects backprop_num_steps consecutive steps from
    `start`, drawn from `generator` unless given."""
    n = cfg.num_sample_steps
    idx = torch.arange(n)
    if cfg.backprop_strategy == "last":
        return idx == n - 1
    if cfg.backprop_strategy == "tail":
        return idx >= n - cfg.backprop_num_steps
    if cfg.backprop_strategy == "uniform":
        stride = max(n // cfg.backprop_num_steps, 1)
        return (idx % stride) == (stride - 1)
    if cfg.backprop_strategy == "random":
        if start is None:
            dev = "cpu" if generator is None else generator.device
            start = int(torch.randint(0, n - cfg.backprop_num_steps + 1, (),
                                      generator=generator, device=dev))
        return (idx >= start) & (idx < start + cfg.backprop_num_steps)
    raise ValueError(cfg.backprop_strategy)


class RewardDraws(NamedTuple):
    """The random inputs of one reward step."""
    noise: torch.Tensor     # the initial latents, float32
    selected: torch.Tensor  # bool[num_sample_steps], backprop_step_mask's


def draw_reward_inputs(generator: Optional[torch.Generator], shape,
                       cfg: RewardConfig, device) -> RewardDraws:
    """N(0, 1) initial latents, then the step mask."""
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    return RewardDraws(noise, backprop_step_mask(cfg, generator))


def make_reward_train_step(
    model: torch.nn.Module,
    vae: torch.nn.Module,
    reward_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: RewardConfig,
    lora_cfg: LoRAConfig,
    train_cfg: TrainConfig,
    scheduler: FlowMatchEulerConfig = FlowMatchEulerConfig(),
    vae_scaling: float = 1.0,
) -> Tuple[Callable, Callable]:
    """Returns (init_fn, step_fn); only the LoRA trains, the transformer and
    the VAE are frozen.

    init_fn(generator=None, lora=None) -> TrainState. step(state, batch,
    generator=None, draws=None) -> (state, {"loss", "reward",
    "grad_norm"}); batch: text (B, S, D), latent_shape (B, C, T, H, W),
    optional negative_text and rope."""
    model.requires_grad_(False)
    vae.requires_grad_(False)
    tx = make_optimizer(train_cfg)
    timesteps, sigmas = flow_match_schedule(scheduler, cfg.num_sample_steps,
                                            mu=1.0)
    dts = (sigmas[1:] - sigmas[:-1]).astype(np.float32)
    vae_dtype = vae.cfg.torch_dtype
    model_dtype = model.cfg.torch_dtype

    def init_fn(generator=None, lora=None) -> TrainState:
        if lora is None:
            lora = lora_init(model, lora_cfg, generator)
        for t in flatten_lora(lora).values():
            t.requires_grad_(True)
        return TrainState(step=0, params=lora,
                          opt_state=tx.init(flatten_lora(lora)))

    def decode(z):
        return vae_decode(vae, (z / vae_scaling).to(vae_dtype))

    def sample_and_reward(batch, draws: RewardDraws):
        txt, rope = batch["text"], batch.get("rope")
        neg = batch.get("negative_text")
        if neg is None:
            neg = torch.zeros_like(txt)
        txt_cfg = torch.cat([neg, txt])
        c = draws.noise.shape[1]
        lat = draws.noise.float()
        for i, selected in enumerate(draws.selected.tolist()):
            lat_in = lat
            if cfg.stop_latent_model_input_gradient:  # DRTune
                lat_in = lat_in.detach()
            with torch.set_grad_enabled(selected):
                both = torch.cat([lat_in, lat_in]).to(model_dtype)
                t_vec = torch.full((both.shape[0],), float(timesteps[i]),
                                   dtype=torch.float32, device=lat.device)
                pred = model(both, t_vec, txt_cfg, rope)[:, :c]
                u, cond = pred.chunk(2)
                pred = u + cfg.guidance_scale * (cond - u)
            lat = lat + float(dts[i]) * pred.float()
        # decode only the first frames, rematerialised in the backward
        z = lat[:, :, :cfg.num_decoded_latents]
        frames = (checkpoint(decode, z, use_reentrant=False)
                  if z.requires_grad else decode(z))
        frames = torch.clamp(frames.float() / 2 + 0.5, 0.0, 1.0)
        reward = reward_fn(frames.permute(0, 2, 3, 4, 1))  # B, T, H, W, C
        return -torch.mean(reward), torch.mean(reward)

    def step(state: TrainState, batch, generator=None, draws=None):
        if draws is None:
            draws = draw_reward_inputs(generator, batch["latent_shape"], cfg,
                                       batch["text"].device)
        flat = flatten_lora(state.params)
        for p in flat.values():
            p.grad = None
        with attach_lora(model, state.params, lora_cfg):
            loss, reward = sample_and_reward(batch, draws)
            if loss.requires_grad:  # else no step was selected: zero grads
                loss.backward()
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in flat.items()}
        metrics = {"loss": loss.detach(), "reward": reward.detach(),
                   "grad_norm": optim.global_norm(grads)}
        updates, opt_state = tx.update(grads, state.opt_state, flat)
        optim.apply_updates(flat, updates)
        for p in flat.values():
            p.grad = None
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return init_fn, step
