"""The port's training step (easyanimate_tpu_torch.training) against the JAX
package: losses and samplers, LR schedules, the optimizer chain on
identical gradients, full SFT and LoRA steps from the same draws, and LoRA
weights carried across in both directions.

Random draws are made once (with numpy, or with the JAX step's own key
split) and handed to both sides. Tolerances, with their reasons:
  - 1e-6 for losses and schedules: the same float32 formulas;
  - 1e-5 relative for optimizer updates on identical gradients: float32
    sums (the global norm) taken in another order;
  - 5e-4 of the largest gradient for model and LoRA gradients, the JAX
    full-model golden test's bound (tests/test_mmdit_full_golden.py);
  - 2 * lr * steps for parameters after full steps: Adam's first update is
    about sign(g) * lr, so a gradient within rounding of 0 may flip sign.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.training import losses as jlosses
from easyanimate_tpu.training import lora as jlora
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu_torch.models.convert import (export_lora_state_dict,
                                                  load_reference_lora_state_dict,
                                                  load_reference_state_dict)
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)
from easyanimate_tpu_torch.training import losses as tlosses
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import optim as toptim
from easyanimate_tpu_torch.training import trainer as ttrainer
from test_torch_mmdit import export_jax_mmdit, port_mmdit_cfg

EXACT_TOL = 1e-6
OPT_TOL = 1e-5
GRAD_TOL = 5e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol if atol is None else atol)


# ---------------------------------------------------------------------------
# losses and samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme,bands", [("logit_normal", 0), ("mode", 0),
                                          ("uniform", 4)])
def test_flow_sigmas_match_jax(scheme, bands):
    cfg_kw = dict(weighting_scheme=scheme, uniform_bands=bands, shift=3.0)
    key = jax.random.PRNGKey(5)
    want_s, want_t = jlosses.sample_flow_sigmas(
        key, 64, jlosses.FlowMatchLossConfig(**cfg_kw))
    # the JAX sampler's own draw, handed to the port's formula
    draw = (jax.random.normal(key, (64,)) if scheme == "logit_normal"
            else jax.random.uniform(key, (64,)))
    got_s, got_t = tlosses.flow_sigmas_from_u(
        torch.from_numpy(np.array(draw)), tlosses.FlowMatchLossConfig(**cfg_kw))
    _close(got_s, want_s, EXACT_TOL)
    _close(got_t, want_t, EXACT_TOL)
    s, t = tlosses.sample_flow_sigmas(torch.Generator().manual_seed(0), 8,
                                      tlosses.FlowMatchLossConfig(**cfg_kw))
    assert s.shape == t.shape == (8,) and bool(((s > 0) & (s <= 1)).all())


def test_flow_losses_match_jax(rng):
    lat, noise = (rng.standard_normal((2, 4, 5, 6, 6)).astype(np.float32)
                  for _ in range(2))
    sig = np.array([0.3, 0.9], np.float32)
    pred = rng.standard_normal(lat.shape).astype(np.float32) * 40
    w = np.array([1.0, 0.5], np.float32)
    jn, jt = jlosses.flow_noise_and_target(*map(jnp.asarray, (lat, noise, sig)))
    tn, tt = tlosses.flow_noise_and_target(*map(torch.from_numpy, (lat, noise, sig)))
    _close(tn, jn, EXACT_TOL)
    _close(tt, jt, EXACT_TOL)
    for weights in (None, w):  # |diff| > 50 masks some elements out
        want = jlosses.masked_mse_loss(
            jnp.asarray(pred), jt, 50.0,
            None if weights is None else jnp.asarray(weights))
        got = tlosses.masked_mse_loss(
            torch.from_numpy(pred), tt, 50.0,
            None if weights is None else torch.from_numpy(weights))
        _close(got, want, EXACT_TOL)
    _close(tlosses.with_motion_sub_loss(got, torch.from_numpy(pred), tt, 0.25),
           jlosses.with_motion_sub_loss(want, jnp.asarray(pred), jt, 0.25),
           EXACT_TOL)
    t = tlosses.ddpm_sample_timesteps(torch.Generator().manual_seed(0), 8,
                                      1000, uniform_bands=4)
    assert all(250 * (i % 4) <= int(v) < 250 * (i % 4 + 1) for i, v in enumerate(t))


# ---------------------------------------------------------------------------
# schedules and the optimizer chain on identical gradients
# ---------------------------------------------------------------------------

_OPT_CASES = {
    "default": dict(),
    "linear_warmup": dict(learning_rate=1e-2, lr_scheduler="linear",
                          lr_warmup_steps=2, max_train_steps=6,
                          max_grad_norm=1.0),
    "cosine_adaptive_clip": dict(learning_rate=1e-2, lr_scheduler="cosine",
                                 lr_warmup_steps=1, max_train_steps=5,
                                 adaptive_grad_clip=True, max_grad_norm=0.5,
                                 initial_grad_norm_ratio=5.0,
                                 abnormal_norm_clip_start=2),
    "dual_lr_frozen": dict(learning_rate=1e-2, weight_decay=0.1,
                           trainable_modules=["attn1"],
                           trainable_modules_low_lr=["ff"]),
    "accumulate_2": dict(learning_rate=1e-2, gradient_accumulation_steps=2,
                         lr_scheduler="linear", lr_warmup_steps=2,
                         max_train_steps=8, max_grad_norm=1.0),
}


@pytest.mark.parametrize("case", ["constant_warmup", "linear_warmup",
                                  "cosine_adaptive_clip", "accumulate_2"])
def test_lr_schedule_matches_optax(case):
    kw = _OPT_CASES.get(case) or dict(learning_rate=1e-3, lr_warmup_steps=3)
    want = jtrainer.make_lr_schedule(jtrainer.TrainConfig(**kw))
    got = ttrainer.make_lr_schedule(ttrainer.TrainConfig(**kw))
    for count in range(12):
        _close(got(count), float(want(count)), EXACT_TOL, atol=1e-9)


_SHAPES = {"blocks.attn1.w": (3, 4), "blocks.attn1.b": (4,),
           "blocks.ff.w": (4, 4), "norm.scale": (4,)}


def _nest(flat):
    out = {}
    for name, a in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(a)
    return out


@pytest.mark.parametrize("case", sorted(_OPT_CASES))
def test_optimizer_matches_optax(rng, case):
    """Five updates of the port's chain against the optax chain on the same
    numpy gradients; step 3's gradients are 20x, so the clip triggers and
    the adaptive clip sees an abnormal norm."""
    kw = _OPT_CASES[case]
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in _SHAPES.items()}
    jparams = _nest(params)
    jtx = jtrainer.make_optimizer(jtrainer.TrainConfig(**kw), jparams)
    jstate = jtx.init(jparams)
    tparams = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ttx = ttrainer.make_optimizer(ttrainer.TrainConfig(**kw), tparams)
    tstate = ttx.init(tparams)
    for i in range(5):
        grads = {n: rng.standard_normal(s).astype(np.float32) * (20 if i == 3 else 0.3)
                 for n, s in _SHAPES.items()}
        upd, jstate = jtx.update(_nest(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        upd_t, tstate = ttx.update({n: torch.from_numpy(g) for n, g in grads.items()},
                                   tstate, tparams)
        toptim.apply_updates(tparams, upd_t)
        for name, p in tparams.items():
            want = jparams
            for part in name.split("."):
                want = want[part]
            _close(p, want, OPT_TOL, atol=1e-7)
    if case == "dual_lr_frozen":  # frozen: not moved, not even by decay
        torch.testing.assert_close(tparams["norm.scale"],
                                   torch.from_numpy(params["norm.scale"]))


def test_unported_options_raise():
    # V5's second text stream is ported: apply_model hands text_t5 to the
    # model as encoder_hidden_states_t5 (tests/test_torch_v5.py holds the
    # V5 steps against JAX); came / adamw8bit and ddpm / sigma are ported
    # and build
    seen = {}

    def model(*args, **kw):
        seen.update(kw)
        return "pred"

    t5 = torch.ones(1, 2, 3)
    assert ttrainer.apply_model(model, None, None,
                                {"text": None, "text_t5": t5}) == "pred"
    assert seen["encoder_hidden_states_t5"] is t5
    for opt in ("came", "adamw8bit"):
        ttrainer.make_optimizer(ttrainer.TrainConfig(optimizer=opt))
    for loss in ("ddpm", "sigma"):
        ttrainer.make_loss_fn(None, ttrainer.TrainConfig(loss_type=loss))
    with pytest.raises(ValueError, match="optimizer"):
        ttrainer.make_optimizer(ttrainer.TrainConfig(optimizer="lion"))
    with pytest.raises(ValueError, match="loss_type"):
        ttrainer.make_loss_fn(None, ttrainer.TrainConfig(loss_type="v"))
    with pytest.raises(ValueError, match="names"):
        ttrainer.make_optimizer(ttrainer.TrainConfig(trainable_modules=["ff"]))
    mult = ttrainer.lr_multiplier_tree(
        ["transformer_blocks.0.attn1.to_q.weight", "transformer_blocks.0.ff.net.2.bias",
         "proj_out.weight"],
        ttrainer.TrainConfig(trainable_modules=["attn1"],
                             trainable_modules_low_lr=["ff."]))
    assert list(mult.values()) == [1.0, 0.5, 0.0]


# ---------------------------------------------------------------------------
# full steps against the JAX steps
# ---------------------------------------------------------------------------


def _tiny(rng, text_len=5):
    """The tiny JAX preset (2 layers, 2 heads x 16, float32; XLA attention:
    the attention kernels' parity is test_torch_attention_grad.py's), its
    exported weights in a port model, and one batch for both."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attn_impl="xla")
    model, variables, sd = export_jax_mmdit(jcfg)
    port = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    load_reference_state_dict(port, sd)
    f, hh, ww = 2, 8, 8
    lat = rng.standard_normal((1, jcfg.in_channels, f, hh, ww)).astype(np.float32)
    txt = rng.standard_normal((1, text_len, jcfg.text_embed_dim)).astype(np.float32)
    crop = get_resize_crop_region_for_grid((hh // 2, ww // 2), 45, 30)
    cos, sin = get_3d_rotary_pos_embed(jcfg.attention_head_dim, crop,
                                       (hh // 2, ww // 2), f)
    jbatch = {"latents": jnp.asarray(lat), "text": jnp.asarray(txt),
              "rope": (jnp.asarray(cos), jnp.asarray(sin))}
    tbatch = {"latents": torch.from_numpy(lat), "text": torch.from_numpy(txt),
              "rope": (torch.from_numpy(cos), torch.from_numpy(sin))}
    return jcfg, model, variables, port, jbatch, tbatch


def _jax_draws(rng_key, latents, loss_cfg):
    """The draws the JAX steps make from `rng_key` (trainer.py:300-303)."""
    rng_s, rng_n = jax.random.split(rng_key)
    sig, ts = jlosses.sample_flow_sigmas(rng_s, latents.shape[0], loss_cfg)
    noise = jax.random.normal(rng_n, latents.shape, jnp.float32)
    return ttrainer.FlowDraws(*(torch.from_numpy(np.array(a))
                                for a in (sig, ts, noise)))


def _check_grads(got, want):
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        _close(got[name], w, GRAD_TOL, atol=GRAD_TOL * scale)


def test_sft_steps_match_jax(rng):
    """Gradients at the start, then two make_train_step steps (AdamW, clip,
    EMA) from the same draws: loss, grad norm, float32 masters, the
    model's own parameters and the EMA."""
    jcfg, model, variables, port, jbatch, tbatch = _tiny(rng)
    kw = dict(learning_rate=2e-5, use_ema=True, ema_decay=0.9)
    jcfg_t, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    keys = [jax.random.PRNGKey(10 + i) for i in range(2)]

    jloss = jtrainer.make_loss_fn(model, jcfg_t)
    jgrads = jax.jit(jax.grad(lambda p: jloss(p, jbatch, keys[0])[0]))(
        variables["params"])
    draws = _jax_draws(keys[0], jbatch["latents"], jcfg_t.loss)
    loss, _ = ttrainer.make_loss_fn(port, tcfg)(tbatch, draws)
    loss.backward()
    want = jconvert.export_mmdit_state_dict({"params": jgrads}, jcfg)
    _check_grads({n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in port.named_parameters()}, want)
    port.zero_grad(set_to_none=True)
    norms = ttrainer.make_param_grad_norms(port, tcfg)(tbatch, draws)
    assert set(norms) == set(want)
    scale = max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        _close(norms[name], np.linalg.norm(w), GRAD_TOL, atol=GRAD_TOL * scale)

    jstate = jtrainer.create_train_state(variables, jcfg_t)
    jstep = jax.jit(jtrainer.make_train_step(model, jcfg_t))
    tstate = ttrainer.create_train_state(port, tcfg)
    tstep = ttrainer.make_train_step(port, tcfg)
    for i, key in enumerate(keys):
        jstate, jm = jstep(jstate, jbatch, key)
        tstate, tm = tstep(tstate, tbatch,
                           draws=_jax_draws(key, jbatch["latents"], jcfg_t.loss))
        _close(tm["loss"], jm["loss"], GRAD_TOL)
        _close(tm["grad_norm"], jm["grad_norm"], GRAD_TOL)
        atol = 2 * kw["learning_rate"] * (i + 1)
        for tree, got in ((jstate.params, tstate.params),
                          ({"params": jstate.ema_params}, tstate.ema_params),
                          (jstate.params, dict(port.named_parameters()))):
            want = jconvert.export_mmdit_state_dict(tree, jcfg)
            assert set(got) == set(want)
            for name, w in want.items():
                _close(got[name], w, 0, atol=atol)
    assert tstate.step == 2


def test_lora_steps_match_jax(rng):
    """LoRA gradients at the start, then two make_lora_train_step steps:
    the JAX step merges the factors into the kernels, the port runs the
    kohya hooks -- the same function, so the same loss and gradients --
    and the base weights stay bitwise unchanged."""
    jcfg, model, variables, port, jbatch, tbatch = _tiny(rng)
    kw = dict(learning_rate=2e-5)
    jcfg_t, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    jlcfg, tlcfg = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
    jinit, jstep = jlora.make_lora_train_step(model, jcfg_t, jlcfg, variables)
    jstate = jinit(jax.random.PRNGKey(3))
    # a non-zero up, so that the first step's down gradients are not all 0
    jstate = jstate.replace(params={
        p: {"down": f["down"], "up": 0.01 * jax.random.normal(
            jax.random.PRNGKey(i), f["up"].shape)}
        for i, (p, f) in enumerate(sorted(jstate.params.items()))})
    lora, lcfg = load_reference_lora_state_dict(
        port, jconvert.export_lora_state_dict(jstate.params, jlcfg.alpha, jcfg),
        device="cpu")
    assert lcfg == tlcfg
    assert set(lora) == set(tlora.target_modules(port, tlcfg))
    tinit, tstep = tlora.make_lora_train_step(port, tcfg, tlcfg)
    tstate = tinit(lora=lora)
    base = {n: p.clone() for n, p in port.state_dict().items()}
    keys = [jax.random.PRNGKey(20 + i) for i in range(2)]

    draws = _jax_draws(keys[0], jbatch["latents"], jcfg_t.loss)

    def jloss(fac):  # the JAX LoRA step's loss (lora.py:119-133)
        merged = {"params": jlora.merge_lora(variables["params"], fac, jlcfg)}
        noisy, target = jlosses.flow_noise_and_target(
            jbatch["latents"], jnp.asarray(draws.noise), jnp.asarray(draws.sigmas))
        pred = model.apply(merged, noisy, jnp.asarray(draws.timesteps),
                           jbatch["text"], jbatch["rope"])
        return jlosses.masked_mse_loss(pred, target)

    jgrads = jax.grad(jloss)(jstate.params)
    with tlora.attach_lora(port, tstate.params, tlcfg):
        pred, target = ttrainer.flow_prediction(port, tbatch, draws)
        tlosses.masked_mse_loss(pred, target).backward()
    want = jconvert.export_lora_state_dict(jgrads, 1.0, jcfg)
    got = export_lora_state_dict(  # unreached factors (last text FFN): 0
        {p: {k: torch.zeros_like(t) if t.grad is None else t.grad
             for k, t in f.items()} for p, f in tstate.params.items()}, 1.0)
    _check_grads(got, want)

    for i, key in enumerate(keys):
        jstate, jm = jstep(jstate, jbatch, key)
        tstate, tm = tstep(tstate, tbatch,
                           draws=_jax_draws(key, jbatch["latents"], jcfg_t.loss))
        _close(tm["loss"], jm["loss"], GRAD_TOL)
        _close(tm["grad_norm"], jm["grad_norm"], GRAD_TOL)
        want = jconvert.export_lora_state_dict(jstate.params, jlcfg.alpha, jcfg)
        got = export_lora_state_dict(tstate.params, tlcfg.alpha)
        for name, w in want.items():
            _close(got[name], w, 0, atol=2 * kw["learning_rate"] * (i + 1))
    for n, p in port.state_dict().items():
        assert torch.equal(p, base[n]), n


# ---------------------------------------------------------------------------
# LoRA weights across the two packages
# ---------------------------------------------------------------------------


def test_lora_carries_across_and_merges_like_jax(rng, tmp_path):
    """JAX lora_init -> kohya dict -> port, port -> kohya dict -> JAX
    convert_lora_state_dict, both exact; merge_lora equals the JAX merge;
    the hooked forward equals the merged forward; save/load round-trips."""
    jcfg, model, variables, port, jbatch, tbatch = _tiny(rng)
    jlcfg = jlora.LoRAConfig(rank=4, alpha=8.0)
    jl = jlora.lora_init(variables["params"], jlcfg, jax.random.PRNGKey(1))
    jl = {p: {"down": f["down"], "up": jnp.asarray(
        rng.standard_normal(f["up"].shape).astype(np.float32) * 0.1)}
        for p, f in jl.items()}
    sd = jconvert.export_lora_state_dict(jl, jlcfg.alpha, jcfg)
    lora, lcfg = load_reference_lora_state_dict(port, sd, device="cpu")
    assert (lcfg.rank, lcfg.alpha) == (4, 8.0)
    back = export_lora_state_dict(lora, lcfg.alpha)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
    jl2, jlcfg2 = jconvert.convert_lora_state_dict(back, jcfg)
    assert (jlcfg2.rank, jlcfg2.alpha) == (4, 8.0)
    for p, f in jl.items():
        for kind in ("down", "up"):
            np.testing.assert_array_equal(np.asarray(jl2[p][kind]),
                                          np.asarray(f[kind]))

    args = (tbatch["latents"], torch.tensor([300.0]), tbatch["text"],
            tbatch["rope"])
    with torch.no_grad(), tlora.attach_lora(port, lora, lcfg):
        hooked = port(*args)
    tlora.merge_lora(port, lora, lcfg)
    want = jconvert.export_mmdit_state_dict(
        {"params": jlora.merge_lora(variables["params"], jl, jlcfg)}, jcfg)
    for name, p in port.state_dict().items():
        _close(p, want[name], 1e-6)
    with torch.no_grad():
        _close(port(*args), hooked, 1e-5)
    tlora.unmerge_lora(port, lora, lcfg)

    tlora.save_lora(str(tmp_path / "lora"), lora, lcfg)
    loaded, cfg2 = tlora.load_lora(str(tmp_path / "lora.npz"), device="cpu")
    assert cfg2 == lcfg
    for p, f in lora.items():
        for kind, t in f.items():
            assert torch.equal(loaded[p][kind], t)


@pytest.mark.parametrize("name", ["x", "x.npz"])
def test_port_loads_a_lora_the_jax_package_saved(rng, tmp_path, name):
    """JAX save_lora("x") writes x.npz + x.json, save_lora("x.npz") writes
    x.npz + x.npz.json: the port's load_lora reads both layouts, factors
    and config exactly, and its save_lora writes the same names. Where a
    config of the other layout lies beside it, the one saved under the
    name given wins."""
    jl = {p: {"down": jnp.asarray(rng.standard_normal((8, 2), np.float32)),
              "up": jnp.asarray(rng.standard_normal((2, 6), np.float32))}
          for p in ("transformer_blocks_0/attn1/to_q", "proj_out")}
    jcfg = jlora.LoRAConfig(rank=2, alpha=4.0, targets="to_q|proj_out")
    jlora.save_lora(str(tmp_path / name), jl, jcfg)
    loaded, cfg = tlora.load_lora(str(tmp_path / name), device="cpu")
    assert cfg == tlora.LoRAConfig(rank=2, alpha=4.0, targets="to_q|proj_out")
    assert set(loaded) == set(jl)
    for p, f in jl.items():
        for kind, t in f.items():
            assert torch.equal(loaded[p][kind], torch.from_numpy(np.asarray(t)))
    written = tmp_path / "port"
    written.mkdir()
    tlora.save_lora(str(written / name), loaded, cfg)
    assert sorted(x.name for x in written.iterdir()) == sorted(
        x.name for x in tmp_path.iterdir() if x.is_file())
    other = "x.json" if name == "x.npz" else "x.npz.json"
    (tmp_path / other).write_text(
        '{"rank": 7, "alpha": 1.0, "targets": "stale"}')
    assert tlora.load_lora(str(tmp_path / name), device="cpu")[1] == cfg
