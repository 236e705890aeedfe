"""The port's LCM-LoRA distillation and reward-backprop steps
(easyanimate_tpu_torch.training.lcm / reward) against the JAX package, the
step masks, the traps of both steps, and the three training entry points'
--tiny_demo (train_lcm_lora, train_reward_lora, train_vae).

Both sides start from the same weights (the port's random tiny MMDiT and
MagViT, converted for JAX by its reference-dict converters; JAX on XLA
attention), the same LoRA and EMA
factors (the JAX ones through the kohya export), and JAX's own draws from
its step key, handed to the port through `draws=`. Tolerances, those of
test_torch_training.py's LoRA test: 5e-4 for losses and gradient norms
(the JAX full-model golden bound), 5e-4 of the largest for each gradient
the optimizer is handed, leaf by leaf, 2 * lr * steps for the factors after
the updates (Adam's first update is about sign(g) * lr).
"""
import argparse
import contextlib
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline.schedulers import DDIMConfig as JDDIMConfig
from easyanimate_tpu.training import lcm as jlcm
from easyanimate_tpu.training import lora as jlora
from easyanimate_tpu.training import reward as jreward
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu_torch import train_lcm_lora, train_reward_lora, train_vae
from easyanimate_tpu_torch.models.convert import (export_lora_state_dict,
                                                  init_random_,
                                                  load_reference_lora_state_dict)
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.pipeline.schedulers import DDIMConfig
from easyanimate_tpu_torch.reward import clip as tclip
from easyanimate_tpu_torch.training import lcm as tlcm
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import optim as toptim
from easyanimate_tpu_torch.training import reward as treward
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.utils.safetensors_io import save_file
from test_torch_mmdit import _rope, port_mmdit_cfg
from test_torch_reward_models import WordTokenizer
from test_torch_train_driver import write_media
from test_torch_vae import port_vae_cfg
from test_torch_vae_training import JAX_TINY as JAX_TINY_VAE

GRAD_TOL = 5e-4
LR = 2e-5
LAT_SHAPE = (1, 4, 2, 8, 8)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol if atol is None else atol)


def _random_weights(module, seed):
    """init_random_ (N(0, 1/fan_in), unit norms, zero biases), then every
    tensor perturbed so biases and norm affines are exercised too."""
    gen = torch.Generator().manual_seed(seed)
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _pair(rng, out_channels=4):
    """The tiny MMDiT (2 layers; JAX on XLA attention): the port's random
    weights, converted for JAX by its own reference-dict converter (faster
    than a JAX init); a batch (latents, text, RoPE) for both."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attn_impl="xla",
                               out_channels=out_channels)
    port = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    variables = jconvert.convert_mmdit_state_dict(
        _random_weights(port, out_channels), jcfg)
    model = JaxModel(jcfg)
    lat = rng.standard_normal(LAT_SHAPE).astype(np.float32)
    txt = rng.standard_normal((1, 5, jcfg.text_embed_dim)).astype(np.float32)
    cos, sin = _rope(jcfg.attention_head_dim, LAT_SHAPE[2], 4, 4)
    jbatch = {"latents": jnp.asarray(lat), "text": jnp.asarray(txt),
              "rope": (jnp.asarray(cos), jnp.asarray(sin))}
    tbatch = {"latents": torch.from_numpy(lat), "text": torch.from_numpy(txt),
              "rope": (torch.from_numpy(cos), torch.from_numpy(sin))}
    return jcfg, model, variables, port, jbatch, tbatch


def _perturbed(lora, seed, scale=0.01):
    """JAX LoRA factors with a non-zero `up`, so the first step's `down`
    gradients are not all 0."""
    return {p: {"down": f["down"] + scale * jax.random.normal(
                    jax.random.PRNGKey(seed + 1000 + i), f["down"].shape),
                "up": scale * jax.random.normal(jax.random.PRNGKey(seed + i),
                                                f["up"].shape)}
            for i, (p, f) in enumerate(sorted(lora.items()))}


def _to_port(port, jfac, jcfg):
    lora, _ = load_reference_lora_state_dict(
        port, jconvert.export_lora_state_dict(jfac, 16.0, jcfg), device="cpu")
    return lora


def _check_factors(got, want, jcfg, atol):
    want = jconvert.export_lora_state_dict(want, 16.0, jcfg)
    got = export_lora_state_dict(got, 16.0)
    assert set(got) == set(want)
    for name, w in want.items():
        _close(got[name], w, 0, atol=atol)


@contextlib.contextmanager
def _grads_seen(module):
    """Within the block, the optimizers that module.make_optimizer builds
    keep each update's input gradients, in call order: a JAX module's as
    {path: {kind: array}} (a host callback, so also under jit), a port
    module's as its flat {'path/kind': tensor}."""
    seen, real = [], module.make_optimizer
    on_jax = module.__name__.startswith("easyanimate_tpu.")

    def factory(*a, **k):
        tx = real(*a, **k)

        def update(grads, state, params=None):
            if on_jax:
                jax.debug.callback(
                    lambda g: seen.append(jax.tree.map(np.asarray, g)), grads)
            else:
                seen.append({n: g.detach().clone() for n, g in grads.items()})
            return tx.update(grads, state, params)

        return (optax if on_jax else toptim).GradientTransformation(tx.init,
                                                                    update)

    module.make_optimizer = factory
    try:
        yield seen
    finally:
        module.make_optimizer = real


def _check_grads(got, want, jcfg):
    """The port's flat gradients against JAX's tree, each leaf within
    GRAD_TOL of the largest |gradient|."""
    jax.effects_barrier()
    lora = {}
    for name, g in got.items():
        path, kind = name.rsplit("/", 1)
        lora.setdefault(path, {})[kind] = g
    want = jconvert.export_lora_state_dict(want, 1.0, jcfg)
    got = export_lora_state_dict(lora, 1.0)
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    assert scale > 0
    for name, w in want.items():
        _close(got[name], w, GRAD_TOL, atol=GRAD_TOL * scale)


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------


def _lcm_draws(key, latents, cfg):
    """The draws the JAX LCM step makes from `key` (lcm.py:101-106)."""
    r_idx, r_noise, r_w = jax.random.split(key, 3)
    b = latents.shape[0]
    idx = jax.random.randint(r_idx, (b,), 0, cfg.num_ddim_timesteps)
    w = jax.random.uniform(r_w, (b,), minval=cfg.w_min, maxval=cfg.w_max)
    noise = jax.random.normal(r_noise, latents.shape, jnp.float32)
    return tlcm.LCMDraws(*(torch.from_numpy(np.array(a)) for a in
                           (idx, noise, w)))


@pytest.fixture(scope="module")
def lcm_case():
    """The tiny MMDiT with 8 output channels: LCM reads the first 4 as eps
    (JAX lcm.py:84-89), the rest must be ignored."""
    rng = np.random.default_rng(1)
    jcfg, model, variables, port, jbatch, tbatch = _pair(rng, out_channels=8)
    lcm_kw = dict(num_ddim_timesteps=10)
    with _grads_seen(jlcm) as jgrads:
        jinit, jstep = jlcm.make_lcm_train_step(
            model, variables, JDDIMConfig(), jlcm.LCMConfig(**lcm_kw),
            jlora.LoRAConfig(rank=4), jtrainer.TrainConfig(learning_rate=LR))
    jstate = jinit(jax.random.PRNGKey(3))
    jstate = jstate.replace(params=_perturbed(jstate.params, 0),
                            ema_params=_perturbed(jstate.params, 50))
    return dict(jcfg=jcfg, port=port, jbatch=jbatch, tbatch=tbatch,
                jstep=jax.jit(jstep), jstate=jstate, lcm_kw=lcm_kw,
                jgrads=jgrads)


def _port_lcm(case, **over):
    port, jcfg, jstate = case["port"], case["jcfg"], case["jstate"]
    init, step = tlcm.make_lcm_train_step(
        port, DDIMConfig(), tlcm.LCMConfig(**case["lcm_kw"], **over),
        tlora.LoRAConfig(rank=4), ttrainer.TrainConfig(learning_rate=LR))
    state = init(lora=_to_port(port, jstate.params, jcfg))
    state.ema_params = _to_port(port, jstate.ema_params, jcfg)
    return state, step


def test_lcm_steps_match_jax(lcm_case):
    """Two steps: loss, grad norm, the gradients handed to the optimizer,
    the updated LoRA and its EMA; the base weights stay bitwise unchanged
    and no hook is left attached."""
    case = lcm_case
    port, jcfg = case["port"], case["jcfg"]
    base = {n: p.clone() for n, p in port.state_dict().items()}
    with _grads_seen(tlcm) as tgrads:
        tstate, tstep = _port_lcm(case)
    jstate, cfg = case["jstate"], jlcm.LCMConfig(**case["lcm_kw"])
    jgrads = case["jgrads"]
    del jgrads[:]
    for i, key in enumerate(jax.random.PRNGKey(40 + i) for i in range(2)):
        jstate, jm = case["jstep"](jstate, case["jbatch"], key)
        tstate, tm = tstep(tstate, case["tbatch"],
                           draws=_lcm_draws(key, case["jbatch"]["latents"], cfg))
        _close(tm["loss"], jm["loss"], GRAD_TOL)
        _close(tm["grad_norm"], jm["grad_norm"], GRAD_TOL)
        _check_grads(tgrads[i], jgrads[i], jcfg)
        _check_factors(tstate.params, jstate.params, jcfg, 2 * LR * (i + 1))
        _check_factors(tstate.ema_params, jstate.ema_params, jcfg,
                       2 * LR * (i + 1))
    assert tstate.step == 2
    for n, p in port.state_dict().items():
        assert torch.equal(p, base[n]), n
    assert not any(m._forward_hooks for m in port.modules())


def test_lcm_boundary_scalings_and_solver_match_jax():
    t = np.array([0, 19, 499, 999])
    for got, want in zip(tlcm.boundary_scalings(torch.from_numpy(t),
                                                tlcm.LCMConfig()),
                         jlcm.boundary_scalings(jnp.asarray(t),
                                                jlcm.LCMConfig())):
        _close(got, want, 1e-6)
    c_skip, c_out = tlcm.boundary_scalings(torch.tensor([0]), tlcm.LCMConfig())
    assert float(c_skip) == 1.0 and float(c_out) == 0.0
    for n in (10, 50):
        js = jlcm.DDIMSolver(JDDIMConfig(), jlcm.LCMConfig(num_ddim_timesteps=n))
        ts = tlcm.DDIMSolver(DDIMConfig(), tlcm.LCMConfig(num_ddim_timesteps=n))
        np.testing.assert_array_equal(ts.timesteps, js.timesteps)
        np.testing.assert_array_equal(ts.prev_timesteps, js.prev_timesteps)
        _close(ts.ac_prev, js.ac_prev, 1e-7)
        _close(ts.alphas_cumprod, js.alphas_cumprod, 1e-7)


def test_trap_lcm_reads_the_first_channels_as_eps(lcm_case):
    """A model whose channels past C hold garbage gives the same step: LCM
    reads out[:, :C] as eps on the DDPM grid, whatever the model predicts
    (V5.1 is flow-trained; JAX lcm.py:84-89)."""
    case = lcm_case
    port = case["port"]
    draws = _lcm_draws(jax.random.PRNGKey(7), case["jbatch"]["latents"],
                       jlcm.LCMConfig(**case["lcm_kw"]))
    losses = []
    for garbage in (False, True):
        state, step = _port_lcm(case)
        hook = None
        if garbage:
            def fill(module, args, out):
                out = out.clone()
                out[:, 4:] = 1e3
                return out
            hook = port.register_forward_hook(fill)
        try:
            losses.append(step(state, case["tbatch"], draws=draws)[1]["loss"])
        finally:
            if hook is not None:
                hook.remove()
    assert torch.equal(losses[0], losses[1])


@pytest.mark.parametrize("kind", ["lcm", "reward"])
def test_trap_unconditional_text_is_zeros(lcm_case, reward_case, kind):
    """No negative_text means zeros (JAX lcm.py:95, reward.py:84), not an
    encoded empty prompt: the step equals the one given zeros, and another
    negative text moves it."""
    if kind == "lcm":
        case = lcm_case
        draws = _lcm_draws(jax.random.PRNGKey(8), case["jbatch"]["latents"],
                           jlcm.LCMConfig(**case["lcm_kw"]))

        def run(batch):
            state, step = _port_lcm(case)
            return step(state, batch, draws=draws)[1]["loss"]
        batch = dict(case["tbatch"])
    else:
        case = reward_case
        rcfg = case["rcfg"](False)
        draws = _reward_draws(jax.random.PRNGKey(8),
                              jreward.RewardConfig(**rcfg))

        def run(batch):
            state, step = _port_reward(case, rcfg)
            return step(state, batch, draws=draws)[1]["loss"]
        batch = dict(case["tbatch"])
    plain = run(batch)
    zeros = run({**batch, "negative_text": torch.zeros_like(batch["text"])})
    other = run({**batch, "negative_text": torch.ones_like(batch["text"])})
    assert torch.equal(plain, zeros)
    assert not torch.allclose(plain, other)


def test_trap_lcm_runs_one_lora_at_a_time(lcm_case, monkeypatch):
    """The target (EMA LoRA) and the teacher run under no_grad before the
    student; the student's forward and backward (its remat recompute)
    run inside its own attach_lora, never with a second LoRA stacked."""
    case = lcm_case
    events, depth = [], [0]
    real = tlora.attach_lora

    @contextlib.contextmanager
    def watched(model, lora, cfg, scale=1.0):
        assert depth[0] == 0, "two LoRAs attached at once"
        depth[0] += 1
        events.append(("attach", torch.is_grad_enabled()))
        try:
            with real(model, lora, cfg, scale):
                yield model
        finally:
            depth[0] -= 1

    monkeypatch.setattr(tlcm, "attach_lora", watched)
    recomputes = []
    block = case["port"].transformer_blocks[0]
    h = block.register_forward_hook(
        lambda m, a, o: recomputes.append(depth[0]))
    try:
        state, step = _port_lcm(case)
        # a full recompute, so that the block's own hook sees it (an early
        # stop ends the recompute inside the block, past its last saved op)
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            step(state, case["tbatch"],
                 generator=torch.Generator().manual_seed(0))
    finally:
        h.remove()
    # target (no grad), then student (grad); the teacher runs with none
    assert events == [("attach", False), ("attach", True)]
    # block 0 ran: teacher x2 (no LoRA), target, student, student's remat
    assert recomputes == [0, 0, 1, 1, 1]


# ---------------------------------------------------------------------------
# reward backprop
# ---------------------------------------------------------------------------


def _reward_draws(key, rcfg_j):
    r_noise, r_sel = jax.random.split(key)
    noise = jax.random.normal(r_noise, LAT_SHAPE, jnp.float32)
    sel = jreward.backprop_step_mask(rcfg_j, r_sel)
    return treward.RewardDraws(torch.from_numpy(np.array(noise)),
                               torch.from_numpy(np.array(sel)))


@pytest.fixture(scope="module")
def reward_case():
    rng = np.random.default_rng(2)
    jcfg, model, variables, port, jbatch, tbatch = _pair(rng)
    del jbatch["latents"], tbatch["latents"]
    jbatch["latent_shape"] = tbatch["latent_shape"] = LAT_SHAPE
    jvae_cfg = dataclasses.replace(JAX_TINY_VAE, scaling_factor=0.5)
    tvae = AutoencoderKLMagvit(port_vae_cfg(jvae_cfg), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(tvae, 5),
                                              jvae_cfg)
    jvae = jmagvit.AutoencoderKLMagvit(jvae_cfg)
    jlora0 = jlora.lora_init(variables["params"], jlora.LoRAConfig(rank=4),
                             jax.random.PRNGKey(4))
    return dict(jcfg=jcfg, model=model, variables=variables, port=port,
                jbatch=jbatch, tbatch=tbatch, jvae=jvae, vparams=vparams,
                tvae=tvae, jlora=_perturbed(jlora0, 60),
                rcfg=lambda drtune: dict(
                    num_sample_steps=3, backprop_strategy="tail",
                    backprop_num_steps=2, guidance_scale=2.0,
                    stop_latent_model_input_gradient=drtune))


def _port_reward(case, rcfg):
    init, step = treward.make_reward_train_step(
        case["port"], case["tvae"],
        lambda frames: torch.mean(frames, dim=(1, 2, 3, 4)),
        treward.RewardConfig(**rcfg), tlora.LoRAConfig(rank=4),
        ttrainer.TrainConfig(learning_rate=LR), vae_scaling=0.5)
    return init(lora=_to_port(case["port"], case["jlora"], case["jcfg"])), step


@pytest.mark.parametrize("drtune", [False, True])
def test_reward_step_matches_jax(reward_case, drtune):
    """One step through 3 sampling steps ('tail', 2 selected), the brightness
    reward of the first decoded frame: loss, reward, grad norm, the
    gradients handed to the optimizer, the updated LoRA; the transformer
    and the VAE unchanged."""
    case = reward_case
    rcfg = case["rcfg"](drtune)
    with _grads_seen(jreward) as jgrads:
        jinit, jstep = jreward.make_reward_train_step(
            case["model"], case["jvae"], case["vparams"], case["variables"],
            lambda frames: jnp.mean(frames, axis=(1, 2, 3, 4)),
            jreward.RewardConfig(**rcfg), jlora.LoRAConfig(rank=4),
            jtrainer.TrainConfig(learning_rate=LR), vae_scaling=0.5)
    jstate = jinit(jax.random.PRNGKey(4)).replace(params=case["jlora"])
    jbatch = case["jbatch"]
    run = jax.jit(lambda st, txt, rope, key: jstep(
        st, {"text": txt, "rope": rope, "latent_shape": LAT_SHAPE}, key))
    key = jax.random.PRNGKey(30)
    jstate, jm = run(jstate, jbatch["text"], jbatch["rope"], key)
    base = [{n: p.clone() for n, p in m.state_dict().items()}
            for m in (case["port"], case["tvae"])]
    with _grads_seen(treward) as tgrads:
        tstate, tstep = _port_reward(case, rcfg)
    tstate, tm = tstep(tstate, case["tbatch"],
                       draws=_reward_draws(key, jreward.RewardConfig(**rcfg)))
    for k in ("loss", "reward", "grad_norm"):
        _close(tm[k], jm[k], GRAD_TOL)
    assert float(tm["grad_norm"]) > 0
    assert len(tgrads) == len(jgrads) == 1
    _check_grads(tgrads[0], jgrads[0], case["jcfg"])
    _check_factors(tstate.params, jstate.params, case["jcfg"], 2 * LR)
    for m, sd in zip((case["port"], case["tvae"]), base):
        for n, p in m.state_dict().items():
            assert torch.equal(p, sd[n]), n


@pytest.mark.parametrize("strategy", ["last", "tail", "uniform", "random"])
@pytest.mark.parametrize("n,k", [(10, 3), (50, 5), (7, 7), (4, 1)])
def test_backprop_step_mask_equals_jax(strategy, n, k):
    jcfg = jreward.RewardConfig(num_sample_steps=n, backprop_strategy=strategy,
                                backprop_num_steps=k)
    tcfg = treward.RewardConfig(num_sample_steps=n, backprop_strategy=strategy,
                                backprop_num_steps=k)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jreward.backprop_step_mask(jcfg, key))
        start = int(jax.random.randint(key, (), 0, n - k + 1))
        got = treward.backprop_step_mask(tcfg, start=start)
        np.testing.assert_array_equal(got.numpy(), want)
        own = treward.backprop_step_mask(
            tcfg, torch.Generator().manual_seed(seed)).numpy()
        assert own.dtype == bool and own.shape == (n,)
        if strategy in ("tail", "random"):
            sel = np.flatnonzero(own)
            assert len(sel) == k and (np.diff(sel) == 1).all()
    with pytest.raises(ValueError):
        treward.backprop_step_mask(dataclasses.replace(tcfg,
                                                       backprop_strategy="x"))


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def _write_clip_dir(path):
    """A tiny random CLIP in a Hugging Face layout directory."""
    cfg = tclip.CLIPConfig(
        tclip.CLIPTextConfig(vocab_size=1000, hidden_size=32,
                             intermediate_size=64, num_hidden_layers=1,
                             num_attention_heads=2, eos_token_id=999),
        tclip.CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                               num_hidden_layers=1, num_attention_heads=2,
                               image_size=32, patch_size=8), projection_dim=16)
    model = init_random_(tclip.CLIPModel(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    path.mkdir()
    save_file({k: v.numpy() for k, v in model.state_dict().items()},
              str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        {"text_config": dataclasses.asdict(cfg.text_config),
         "vision_config": dataclasses.asdict(cfg.vision_config),
         "projection_dim": cfg.projection_dim}))


def test_trap_reward_driver_scores_every_prompt(tmp_path, rng):
    """train_reward_lora's CLIP-family reward scores the frames against
    every line of --prompt_path (examples/train_reward_lora.py:133-135):
    the mean of the per-prompt scores; it needs a caller's tokenizer."""
    _write_clip_dir(tmp_path / "clip")
    prompts = ["a cat", "a dog on a hill", "rain over the sea"]
    (tmp_path / "p.txt").write_text("\n".join(prompts))
    args = train_reward_lora.parse_args([
        "--reward", "clip", "--reward_model_path", str(tmp_path / "clip"),
        "--prompt_path", str(tmp_path / "p.txt")])
    with pytest.raises(SystemExit, match="tokenizer"):
        train_reward_lora.make_reward_fn(args, "cpu")
    reward_fn = train_reward_lora.make_reward_fn(args, "cpu", WordTokenizer())
    frames = torch.from_numpy(rng.random((1, 1, 24, 24, 3), np.float32))
    from easyanimate_tpu_torch.reward import CLIPScoreReward

    scorer = CLIPScoreReward(tclip.CLIPModel.from_pretrained(
        str(tmp_path / "clip"), device="cpu"), WordTokenizer())
    each = [float(scorer(frames, [p])[1]) for p in prompts]
    got = reward_fn(frames)
    assert got.shape == (1,)
    _close(got[0], np.mean(each), 1e-5)


def test_train_lcm_lora_tiny_demo(tmp_path):
    out = train_lcm_lora.main(["--tiny_demo", "--output_dir", str(tmp_path)],
                              device="cpu")
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert out["state"].step == 3
    lora, cfg = tlora.load_lora(out["lora_path"], device="cpu")
    assert cfg.rank == 2 and set(lora) == set(out["state"].params)
    args = train_lcm_lora.parse_args([])
    assert (args.lora_rank, args.learning_rate, args.num_ddim_timesteps,
            args.ema_decay, args.output_dir) == (64, 1e-4, 50, 0.95,
                                                 "runs/train_lcm")


def test_train_reward_lora_tiny_demo(tmp_path):
    out = train_reward_lora.main(["--tiny_demo", "--output_dir",
                                  str(tmp_path)], device="cpu")
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert all(0 < r < 1 for r in out["rewards"])  # mean brightness
    lora, cfg = tlora.load_lora(out["lora_path"], device="cpu")
    assert cfg.rank == 2
    args = train_reward_lora.parse_args([])
    assert (args.reward, args.lora_rank, args.num_sample_steps,
            args.backprop_strategy, args.guidance_scale) == (
                "brightness", 32, 50, "last", 6.0)
    with pytest.raises(SystemExit):
        train_reward_lora.parse_args(["--reward", "mps"])


def test_train_vae_tiny_demo(tmp_path):
    out = train_vae.main(["--tiny_demo", "--output_dir", str(tmp_path)],
                         device="cpu")
    aux, daux = out["aux"], out["daux"]
    assert out["state"].step == 4
    assert all(np.isfinite(float(v)) for v in {**aux, **daux}.values())
    assert (tmp_path / "metrics.jsonl").read_text().count("\n") == 4
    args = train_vae.parse_args(["--checkpointing_steps", "7"])
    assert (args.sample_size, args.video_sample_n_frames, args.disc_start,
            args.checkpointing_steps) == (256, 17, 50, 7)


def test_driver_data_paths_read_the_manifest(tmp_path):
    """The --model_path / --train_data_meta paths' batches on a manifest of
    two images: LCM's posterior latents x scaling_factor at 384x672 with
    the prompts' embeddings and RoPE on the latent grid; the VAE trainer's
    square clips in [-1, 1] at --sample_size."""
    entries = write_media(str(tmp_path), n_images=2, n_videos=0)
    (tmp_path / "train.json").write_text(json.dumps(entries))
    from easyanimate_tpu_torch.train import _tiny_models

    model, vae = _tiny_models(False, device="cpu", seed=0)
    pipe = types.SimpleNamespace(transformer=model, vae=vae)
    args = argparse.Namespace(train_data_meta=str(tmp_path / "train.json"),
                              train_data_dir=str(tmp_path), seed=0,
                              train_batch_size=1, max_train_steps=2)
    prompts = []

    def encode_text(texts):
        prompts.extend(texts)
        return {"text": torch.zeros(len(texts), 3, model.cfg.text_embed_dim)}

    batches = list(train_lcm_lora._data_batches(args, pipe, encode_text, "cpu"))
    assert len(batches) == 2 and sorted(prompts) == ["image 0", "image 1"]
    for b in batches:
        sf = vae.cfg.spatial_compression
        assert b["latents"].shape == (1, 4, 1, 384 // sf, 672 // sf)
        grid = (384 // sf // 2) * (672 // sf // 2)
        assert b["rope"][0].shape == (grid, model.cfg.attention_head_dim)
        assert b["text"].shape == (1, 3, model.cfg.text_embed_dim)
    vargs = train_vae.parse_args(["--train_data_meta",
                                  str(tmp_path / "train.json"),
                                  "--train_data_dir", str(tmp_path),
                                  "--sample_size", "16",
                                  "--video_sample_n_frames", "3"])
    video = next(train_vae._data_batches(vargs, "cpu"))["video"]
    assert video.shape == (1, 3, 1, 16, 16)
    assert float(video.min()) >= -1.0 and float(video.max()) <= 1.0

