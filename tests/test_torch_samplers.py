"""Parity of the port's five other samplers with the JAX package: DDIM,
Euler, Euler-Ancestral, PNDM (PLMS) and DPM-Solver++ (2M).

Every schedule (timesteps, sigmas, alphas, PNDM's per-eval rows, with and
without t_start) and every step function against JAX at rtol 1e-5, atol
1e-5, on numpy draws from a seed handed to both packages; Euler-A gets the
same handed noise (JAX folds the step into its key, which a
torch.Generator cannot reproduce, so its pipeline run gets a seeded
determinism check instead). The tiny 6-head MMDiT of
tests/test_torch_serving.py with the 2-block MagViT of
tests/test_torch_control.py, 16x16x5f (weights crossed from the port to
JAX through the reference-layout dicts, float32) runs DDIM, Euler, DPM++
and PNDM from the same initial noise to LATENT_TOL = 5e-4; the inpaint
pipeline runs Euler's and DDIM's V2V initialisation at strength 0.5. Both
pipelines are built once per module, and JAX compiles one loop per
sampler family.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline import inpaint as jinpaint
from easyanimate_tpu.pipeline import schedulers as js
from easyanimate_tpu.pipeline import t2v as jt2v
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.pipeline import schedulers as ts
from easyanimate_tpu_torch.pipeline.inpaint import EasyAnimateInpaintPipeline
from easyanimate_tpu_torch.pipeline.t2v import EasyAnimatePipeline
from tests.test_torch_control import JAX_VAE
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_serving import _random_weights
from tests.test_torch_vae import port_vae_cfg

TOL = dict(rtol=1e-5, atol=1e-5)
H = W = 16
FRAMES, STEPS = 5, 4
SPACINGS = ("leading", "linspace", "trailing")
NAMES = ("Flow", "DDIM", "Euler", "Euler A", "DPM++", "PNDM")


def _cfgs(cls_name, **kw):
    """The same config in both packages."""
    return getattr(js, cls_name)(**kw), getattr(ts, cls_name)(**kw)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spacing", SPACINGS)
@pytest.mark.parametrize("beta_schedule",
                         ["scaled_linear", "linear", "squaredcos_cap_v2"])
def test_schedules_match_jax(spacing, beta_schedule):
    """DDIM's, Euler's and PNDM's schedules and the loop's per-step rows
    (JAX schedule_arrays) for every family, at 1 to 25 steps and every
    t_start of a 10-step V2V."""
    kw = dict(timestep_spacing=spacing, beta_schedule=beta_schedule,
              steps_offset=1 if spacing == "leading" else 0)
    jd, td = _cfgs("DDIMConfig", **kw)
    np.testing.assert_array_equal(ts.make_betas(td), js.make_betas(jd))
    for steps in (1, 2, 4, 25):
        for got, want in zip(ts.ddim_schedule(td, steps),
                             js.ddim_schedule(jd, steps)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        je, te = _cfgs("EulerConfig", **kw)
        got, want = ts.euler_schedule(te, steps), js.euler_schedule(je, steps)
        for g, w in zip(got, want):
            _close(g, w)
        for t_start in ((0,) if steps == 1 else (0, 1, steps - 1)):
            jp, tp = _cfgs("PNDMConfig", **kw)
            for g, w in zip(ts.pndm_schedule(tp, steps, t_start),
                            js.pndm_schedule(jp, steps, t_start)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for cls_name in ("FlowMatchEulerConfig", "DDIMConfig", "EulerConfig",
                     "EulerAncestralConfig", "PNDMConfig", "DPMSolverConfig"):
        fkw = {} if cls_name == "FlowMatchEulerConfig" else kw
        jc, tc = _cfgs(cls_name, **fkw)
        for t_start in range(10):
            got = ts.schedule_arrays(tc, 10, t_start)
            want = jt2v.EasyAnimatePipeline.schedule_arrays(None, 10, t_start,
                                                            jc)
            np.testing.assert_array_equal(got[0], np.asarray(want[0]))
            if want[1] is None:
                assert got[1] is None
            else:
                for g, w in zip(got[1], want[1]):
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prediction_type",
                         ["epsilon", "v_prediction", "sample"])
def test_step_functions_match_jax(rng, prediction_type):
    x, out, prev_x0, noise = (rng.standard_normal((2, 4, 3, 6, 6))
                              .astype(np.float32) for _ in range(4))
    tx, tout, tprev, tnoise = map(torch.from_numpy, (x, out, prev_x0, noise))
    jx, jout, jprev, jnoise = map(jnp.asarray, (x, out, prev_x0, noise))
    for clip in (False, True):
        kw = dict(prediction_type=prediction_type, clip_sample=clip)
        jd, td = _cfgs("DDIMConfig", **kw)
        _, ac, fa = ts.ddim_schedule(td, 10)
        jac = jnp.asarray(ac)
        for t, t_prev in ((999, 899), (499, 399), (99, -1), (0, -1)):
            _close(ts.ddim_step(td, tx, tout, t, t_prev, ac, fa),
                   js.ddim_step(jd, jx, jout, jnp.int32(t),
                                jnp.int32(t_prev), jac, fa))
            _close(ts.ddim_add_noise(tx, tnoise, t, ac),
                   js.ddim_add_noise(jx, jnoise, jnp.int32(t), jac))
            jdp, tdp = _cfgs("DPMSolverConfig", **kw)
            for idx in (0, 3):
                got = ts.dpm_solver_step(tdp, tx, tout, t, t_prev, tprev,
                                         idx, ac)
                want = js.dpm_solver_step(jdp, jx, jout, jnp.int32(t),
                                          jnp.int32(t_prev), jprev,
                                          jnp.int32(idx), jac)
                for g, w in zip(got, want):
                    _close(g, w)
            if t_prev >= 0:
                _close(ts.dpm_lambda(ac, t_prev), js.dpm_lambda(jac, t_prev))
        if clip:
            continue
        je, te = _cfgs("EulerConfig", **kw)
        jea, tea = _cfgs("EulerAncestralConfig", **kw)
        for sigma, sigma_next in ((14.6, 9.1), (3.0, 0.5), (0.7, 0.0)):
            s, sn = np.float32(sigma), np.float32(sigma_next)
            _close(ts.euler_scale_model_input(tx, s),
                   js.euler_scale_model_input(jx, jnp.float32(s)))
            _close(ts.euler_step(te, tx, tout, s, sn),
                   js.euler_step(je, jx, jout, jnp.float32(s),
                                 jnp.float32(sn)))
            _close(ts.euler_ancestral_step(tea, tx, tout, s, sn, tnoise),
                   js.euler_ancestral_step(jea, jx, jout, jnp.float32(s),
                                           jnp.float32(sn), jnoise))
        jp, tp = _cfgs("PNDMConfig", **kw)
        rows, ac, fa = ts.pndm_schedule(tp, 10)
        for t, t_prev in ((999, 899), (900, 800), (99, -1)):
            _close(ts.pndm_prev_sample(tp, tx, tout, t, t_prev, ac, fa),
                   js.pndm_prev_sample(jp, jx, jout, jnp.int32(t),
                                       jnp.int32(t_prev), jnp.asarray(ac),
                                       fa))
    ets = rng.standard_normal((4, 2, 4, 3, 6, 6)).astype(np.float32)
    for order in range(5):
        _close(ts.pndm_combine(order, tout, list(torch.from_numpy(ets))),
               js.pndm_combine(jnp.int32(order), jout, jnp.asarray(ets)))


def test_bf16_steps_return_the_latents_dtype(rng):
    """Each step computes in float32 and hands back the latents' dtype."""
    x = torch.from_numpy(rng.standard_normal((1, 4, 2, 4, 4)).astype(
        np.float32)).to(torch.bfloat16)
    _, ac, fa = ts.ddim_schedule(ts.DDIMConfig(), 4)
    assert ts.ddim_step(ts.DDIMConfig(), x, x, 999, 749, ac,
                        fa).dtype == torch.bfloat16
    assert ts.euler_step(ts.EulerConfig(), x, x, 3.0,
                         1.0).dtype == torch.bfloat16
    loop = ts.SamplerLoop(ts.PNDMConfig(), 4)
    for i in range(len(loop)):
        assert loop.step(i, x, x).dtype == torch.bfloat16
    loop = ts.SamplerLoop(ts.DPMSolverConfig(), 4)
    assert loop.step(0, x, x).dtype == torch.bfloat16
    assert loop.prev_x0.dtype == torch.float32


def test_init_noise_sigma_and_make_scheduler_match_jax():
    """init_noise_sigma for every family and spacing; make_scheduler from
    every base to every name copies the fields JAX copies."""
    bases = [None, js.FlowMatchEulerConfig(num_train_timesteps=500, shift=5.0),
             js.DDIMConfig(num_train_timesteps=250, beta_end=0.012,
                           prediction_type="v_prediction",
                           timestep_spacing="trailing"),
             js.EulerConfig(steps_offset=1),
             js.DPMSolverConfig(solver_order=3)]
    for base in bases:
        tbase = (None if base is None else getattr(ts, type(base).__name__)(
            **dataclasses.asdict(base)))
        for name in NAMES + ("euler ancestral", "dpm_solver", "flow-match"):
            want = js.make_scheduler(name, base=base)
            got = ts.make_scheduler(name, base=tbase)
            assert type(got).__name__ == type(want).__name__
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            for steps in (1, 4, 25):
                np.testing.assert_allclose(ts.init_noise_sigma(got, steps),
                                           js.init_noise_sigma(want, steps),
                                           rtol=1e-12)
    assert ts.make_scheduler("DPM++", base=ts.DPMSolverConfig(
        solver_order=3)).solver_order == 3
    with pytest.raises(ValueError, match="unknown sampler"):
        ts.make_scheduler("nope")


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """The tiny T2V and inpaint pipelines in both packages on the same
    weights: (JAX t2v, port t2v, JAX inpaint, port inpaint)."""
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0),
                                              JAX_VAE)
    jvae = jmagvit.AutoencoderKLMagvit(JAX_VAE)
    out = []
    for in_ch, seed, jcls, tcls in (
            (4, 2, jt2v.EasyAnimatePipeline, EasyAnimatePipeline),
            (9, 1, jinpaint.EasyAnimateInpaintPipeline,
             EasyAnimateInpaintPipeline)):
        jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                                   in_channels=in_ch)
        model = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
        jparams = jconvert.convert_mmdit_state_dict(
            _random_weights(model, seed), jcfg)
        out += [jcls(transformer=JaxModel(jcfg), vae=jvae,
                     transformer_params=jparams, vae_params=vparams),
                tcls(model, vae, "cpu")]
    return out


def _set_sampler(name, *pipes_):
    for p in pipes_:
        mod = ts if isinstance(p, EasyAnimatePipeline) else js
        p.scheduler = mod.make_scheduler(name, base=mod.FlowMatchEulerConfig())


@pytest.mark.parametrize("name", ["DDIM", "Euler", "DPM++", "PNDM"])
def test_t2v_pipeline_with_each_sampler_matches_jax(pipes, name):
    """From the same unit-variance noise (both scale it by
    init_noise_sigma), 4 CFG steps; PNDM's 5 evaluations run every PLMS
    order, DPM++'s last step is first order."""
    jpipe, pipe = pipes[:2]
    _set_sampler(name, jpipe, pipe)
    rng = np.random.default_rng(5)
    lat0 = rng.standard_normal(pipe.latent_shape(1, FRAMES, H, W)).astype(
        np.float32)
    pos = rng.standard_normal((1, 6, 24)).astype(np.float32)
    kw = dict(height=H, width=W, video_length=FRAMES,
              num_inference_steps=STEPS, guidance_scale=6.0,
              output_type="latent")
    want = np.asarray(jpipe(jnp.asarray(pos), jnp.zeros((1, 6, 24)),
                            latents=jnp.asarray(lat0), **kw))
    seen = []
    got = pipe(torch.from_numpy(pos), torch.zeros(1, 6, 24),
               latents=torch.from_numpy(lat0),
               callback=lambda i, lat: seen.append(i), **kw).numpy()
    assert seen == list(range(STEPS + (name == "PNDM")))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=LATENT_TOL, rtol=LATENT_TOL)


def test_euler_ancestral_is_seeded(pipes):
    """Euler-A's step noise comes from the request's generator: one seed
    gives one result, another seed another."""
    pipe = pipes[1]
    _set_sampler("Euler A", pipe)
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=3,
              guidance_scale=6.0, output_type="latent")
    pos = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 6, 24)).astype(np.float32))
    run = lambda seed: pipe(pos, torch.zeros_like(pos), generator=torch.
                            Generator().manual_seed(seed), **kw)
    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.isfinite(a).all() and (a - c).abs().max() > 1e-3


@pytest.mark.parametrize("name", ["Euler", "DDIM"])
def test_v2v_init_per_sampler_matches_jax(pipes, name):
    """Strength 0.5 of 4 steps: Euler starts from video + sigma0 noise,
    DDIM from ddim_add_noise at t0 (JAX inpaint.py:175-192); the noise is
    JAX's draw from its key, handed to the port."""
    jpipe, pipe = pipes[2:]
    _set_sampler(name, jpipe, pipe)
    rng = np.random.default_rng(7)
    video = rng.random((1, 3, FRAMES, H, W)).astype(np.float32)
    mask = np.ones((1, 1, FRAMES, H, W), np.float32)
    pos = rng.standard_normal((1, 6, 24)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(
        jax.random.split(key)[0], pipe.latent_shape(1, FRAMES, H, W),
        jnp.float32))
    kw = dict(height=H, width=W, video_length=FRAMES,
              num_inference_steps=STEPS, guidance_scale=6.0, strength=0.5,
              noise_aug_strength=0.0, output_type="latent")
    want = np.asarray(jpipe(jnp.asarray(pos), jnp.zeros((1, 6, 24)),
                            video=jnp.asarray(video),
                            mask_video=jnp.asarray(mask), rng=key, **kw))
    seen = []
    got = pipe(torch.from_numpy(pos), torch.zeros(1, 6, 24), video=video,
               mask_video=mask, latents=torch.from_numpy(noise),
               callback=lambda i, lat: seen.append(i), **kw).numpy()
    assert seen == [0, 1]
    np.testing.assert_allclose(got, want, atol=LATENT_TOL, rtol=LATENT_TOL)
