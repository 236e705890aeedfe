"""The port's VAE trainer (easyanimate_tpu_torch.training.vae_losses /
vae_trainer, train_vae) against the JAX package: LPIPS, both PatchGAN
discriminators, every loss, the adaptive GAN weight, the MagViT's
gradients, and one ae_step + disc_step pair from the same weights and
draws; the Flax-default and layout traps. The driver's --tiny_demo is
in test_torch_lcm_reward.py, with the other two drivers'.

Weights: LPIPS from the port's random weights through the JAX package's
converter of the torch `lpips` layout; the discriminators and the VAE from
JAX inits (the VAE's as the JAX trainer's: its 1e5-weighted outlier
penalty multiplies float32 rounding of moments past 3 stds) through the
port's converters (state_dict_from_flax, the VAE's reference-layout
export). JAX is channels-last, the port channels-first:
inputs are transposed once, in the test. Tolerances: 1e-5 (rtol and atol,
atol over the largest value) for one module or loss; the train steps
LOSS_RTOL and PARAM_ATOL, as tests/test_torch_train_driver.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.training import vae_losses as jl
from easyanimate_tpu.training import vae_trainer as jt
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  load_reference_state_dict)
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit, gaussian_kl
from easyanimate_tpu_torch.training import vae_losses as tl
from easyanimate_tpu_torch.training import vae_trainer as tt
from test_torch_vae import export_jax_vae, port_vae_cfg

TOL = 1e-5
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
# the JAX tiny trainer config (tests/test_vae_training.py) in the port's
# cache_mag form: encode_chunk / decode_chunk take the whole clip either way
JAX_TINY = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2)


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol * scale)


def _cl(x):
    """channels-first (B, C, ...) numpy -> channels-last jnp."""
    return jnp.asarray(np.moveaxis(x, 1, -1))


@pytest.fixture(scope="module")
def lpips_pair():
    """The port's random LPIPS (lin heads perturbed off 1, some negative:
    |w| is used) and JAX's from the torch `lpips` layout of it."""
    port = init_random_(tl.LPIPS(device="cpu"), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for lin in port.lins:
            lin.weight.normal_(0.0, 1.0, generator=torch.Generator(
                ).manual_seed(lin.weight.numel()))
    ref = {}
    for ci, ti in enumerate(tl._TV_CONV_INDEX):
        conv = getattr(port.vgg, f"conv{ci}")
        ref[f"net.features.{ti}.weight"] = conv.weight.detach().numpy()
        ref[f"net.features.{ti}.bias"] = conv.bias.detach().numpy()
    for i, lin in enumerate(port.lins):
        ref[f"lin{i}.model.1.weight"] = lin.weight.detach().numpy()[
            None, :, None, None]
    return port, jl.convert_lpips_state_dict(ref), ref


def test_lpips_matches_jax(rng, lpips_pair):
    port, jparams, ref = lpips_pair
    for name, sd in (("torch layout", tl.convert_lpips_state_dict(ref)),
                     ("JAX tree", tl.state_dict_from_flax(jparams))):
        assert set(sd) == set(port.state_dict()), name
        for k, v in port.state_dict().items():
            assert torch.equal(sd[k], v), (name, k)
    x, y = (rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
            for _ in range(2))
    want = jax.jit(jl.LPIPS().apply)(jparams, _cl(x), _cl(y))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(y))
        same = port(torch.from_numpy(x), torch.from_numpy(x))
    assert got.shape == (2,)
    _close(got, want)
    np.testing.assert_allclose(_np(same), 0.0, atol=1e-6)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_discriminators_match_jax(rng, kind):
    """base 16, 3 layers: GroupNorm(32) at 32 and 64 channels, (16 at 128
    would be min(32, 128) = 32 too); norm affines perturbed."""
    jcls, tcls = ((jl.Discriminator2D, tl.Discriminator2D) if kind == "2d"
                  else (jl.Discriminator3D, tl.Discriminator3D))
    shape = (2, 3, 32, 32) if kind == "2d" else (1, 3, 5, 32, 32)
    x = rng.standard_normal(shape).astype(np.float32)
    jdisc = jcls(base_channels=16, num_layers=3)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), _cl(x))
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape).astype(np.float32)), params)
    port = tcls(16, 3, device="cpu")
    port.load_state_dict(tl.state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = np.moveaxis(np.asarray(jax.jit(jdisc.apply)(params, _cl(x))), -1, 1)
    assert got.shape == want.shape
    _close(got, want)


def test_losses_match_jax(rng, lpips_pair):
    port_lpips, jparams, _ = lpips_pair
    real, fake = (rng.standard_normal((2, 1, 3, 4, 4)).astype(np.float32)
                  for _ in range(2))
    for j, t in ((jl.hinge_d_loss(_cl(real), _cl(fake)),
                  tl.hinge_d_loss(*map(torch.from_numpy, (real, fake)))),
                 (jl.hinge_g_loss(_cl(fake)),
                  tl.hinge_g_loss(torch.from_numpy(fake)))):
        _close(t, j)
    assert float(tl.hinge_d_loss(torch.full((2,), 2.0),
                                 torch.full((2,), -2.0))) == 0.0

    cfg = dict(perceptual_weight=0.7, l2_weight=0.3, kl_weight=1e-3,
               outlier_penalty=10.0)
    jcfg, tcfg = jl.VAELossConfig(**cfg), tl.VAELossConfig(**cfg)
    video, recon = (rng.uniform(-1, 1, (1, 3, 2, 32, 32)).astype(np.float32)
                    for _ in range(2))
    jlp = lambda a, b: jax.jit(jl.LPIPS().apply)(jparams, a, b)
    want, want_aux = jl.reconstruction_loss(jcfg, _cl(video), _cl(recon), jlp)
    with torch.no_grad():
        got, aux = tl.reconstruction_loss(tcfg, torch.from_numpy(video),
                                          torch.from_numpy(recon), port_lpips)
    _close(got, want)
    assert set(aux) == set(want_aux) == {"l1", "l2", "perceptual"}
    for k in aux:
        _close(aux[k], want_aux[k])

    moments = rng.standard_normal((2, 8, 3, 6, 6)).astype(np.float32)
    moments[:, 4:] *= 20  # logvar beyond the clamp on both sides
    moments[0, 0, 1, 2, 3] = 40.0  # an outlier for the penalty
    _close(tl.kl_and_outlier_loss(tcfg, torch.from_numpy(moments)),
           jl.kl_and_outlier_loss(jcfg, _cl(moments)))
    _close(gaussian_kl(torch.from_numpy(moments)),
           jmagvit.gaussian_kl(jnp.asarray(moments), axis=1))
    for a, b in ((10.0, 1e-9), (0.3, 0.7), (0.0, 2.0)):
        _close(tl.adaptive_gan_weight(torch.tensor(a), torch.tensor(b), 0.5),
               jl.adaptive_gan_weight(jnp.asarray(a), jnp.asarray(b), 0.5))
    assert float(tl.adaptive_gan_weight(torch.tensor(10.0),
                                        torch.tensor(1e-9), 0.5)) == 0.5 * 1e4


def test_trap_outlier_penalty_spatial_axes_and_population_std(rng):
    """The penalty's mean and std run over H and W of each frame and
    channel: axes (3, 4) of (B, C, T, H, W), (2, 3) of JAX's (B, T, H, W,
    C); the std is the population std (jnp.std), not torch's default
    Bessel-corrected one."""
    x = rng.standard_normal((2, 4, 3, 5, 5)).astype(np.float32)
    x[0, 1, 2, 0, 4] = 30.0
    got = tl.outlier_penalty_loss(torch.from_numpy(x), 1.5)
    _close(got, jl.outlier_penalty_loss(_cl(x), 1.5))
    mean = x.mean(axis=(3, 4), keepdims=True)
    std = x.std(axis=(3, 4), keepdims=True)  # numpy: population
    want = np.maximum(np.abs(x - mean) - 1.5 * std, 0).sum(axis=(3, 4)).mean() / 25
    _close(got, want)
    bessel = torch.from_numpy(x).std(dim=(3, 4), keepdim=True)
    assert not np.allclose(_np(bessel), std, rtol=1e-3)


def test_trap_discriminator_group_norm_eps_is_flax_default(rng):
    """GroupNorm eps 1e-6 (Flax), not torch's 1e-5: on inputs of variance
    ~1e-6 the two outputs differ by far more than rounding."""
    port = tl.Discriminator2D(8, 1, device="cpu")
    assert all(m.eps == 1e-6 for m in port.modules()
               if isinstance(m, torch.nn.GroupNorm))
    x = (1e-4 * rng.standard_normal((1, 3, 16, 16))).astype(np.float32)
    jdisc = jl.Discriminator2D(base_channels=8, num_layers=1)
    params = jax.jit(jdisc.init)(jax.random.PRNGKey(1), _cl(x))
    port.load_state_dict(tl.state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        port.norm1.eps = 1e-5
        torch_eps = port(torch.from_numpy(x))
    _close(got, np.moveaxis(np.asarray(jdisc.apply(params, _cl(x))), -1, 1),
           1e-4)
    assert float((torch_eps - got).abs().max()) > 1e-3 * float(got.abs().max())


# ---------------------------------------------------------------------------
# the MagViT's gradients and the train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_models():
    """The tiny MagViT from a JAX init as the JAX trainer makes it (norm
    affines and biases perturbed) and a JAX Discriminator3D init."""
    jvae, vparams, sd = export_jax_vae(JAX_TINY, seed=3)
    jdisc = jl.Discriminator3D(base_channels=8, num_layers=2)
    dparams = jax.jit(jdisc.init)(jax.random.PRNGKey(1),
                                  jnp.zeros((1, 3, 16, 16, 3)))
    return jvae, vparams, sd, jdisc, dparams


def _port_models(sd, dparams):
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY), device="cpu")
    load_reference_state_dict(vae, sd)
    disc = tl.Discriminator3D(8, 2, device="cpu")
    disc.load_state_dict(tl.state_dict_from_flax(dparams), strict=True)
    return vae, disc


def test_vae_chunks_are_differentiable_like_jax(rng, tiny_models):
    """encode_chunk and decode_chunk with cache=None under autograd: the
    gradient of a scalar of the reconstruction with respect to the input
    clip and to the decoder's last conv, against jax.grad."""
    jvae, vparams, sd, _, dparams = tiny_models
    vae, _ = _port_models(sd, dparams)
    x = rng.standard_normal((1, 3, 3, 16, 16)).astype(np.float32)
    w = rng.standard_normal((1, 3, 3, 16, 16)).astype(np.float32)

    def jloss(params, video):
        m, _ = jvae.apply(params, video, None, method=jvae.encode_chunk)
        mean = jnp.split(m, 2, axis=-1)[0]
        r, _ = jvae.apply(params, mean, None, method=jvae.decode_chunk)
        return jnp.sum(r * _cl(w))

    jg_p, jg_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(vparams, _cl(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    m, _ = vae.encode_chunk(xt, None)
    r, _ = vae.decode_chunk(m.chunk(2, dim=1)[0], None)
    (r * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, np.moveaxis(np.asarray(jg_x), -1, 1), 5e-4)
    want = jg_p["params"]["decoder"]["conv_out"]["kernel"]  # (t, h, w, i, o)
    _close(vae.decoder.conv_out.weight.grad,
           np.transpose(np.asarray(want), (4, 3, 0, 1, 2)), 5e-4)


def test_vae_train_steps_match_jax(rng, tiny_models, lpips_pair):
    """One ae_step + disc_step pair with LPIPS, disc_start 0 (the GAN branch
    and the adaptive weight both on), EMA on: every aux value, the VAE's and the
    discriminator's parameters and the EMA, from the same sample draws
    (JAX's own normal(key, mean.shape), transposed). One pair: Adam's
    first update is ~lr * sign(g), so an element of a gradient within
    rounding of 0 may take either sign, and a second step reads the
    parameters that differ there (its d_weight moved by 0.2%)."""
    jvae, vparams, sd, jdisc, dparams = tiny_models
    vae, disc = _port_models(sd, dparams)
    port_lpips, jlp_params, _ = lpips_pair
    kw = dict(use_ema=True, ema_decay=0.9,
              loss=dict(disc_start=0, perceptual_weight=0.5))
    jcfg = jt.VAETrainConfig(**{**kw, "loss": jl.VAELossConfig(**kw["loss"])})
    tcfg = tt.VAETrainConfig(**{**kw, "loss": tl.VAELossConfig(**kw["loss"])})
    jlpips = lambda a, b: jl.LPIPS().apply(jlp_params, a, b)
    jae, jds = (jax.jit(f) for f in jt.make_vae_train_steps(
        jvae, jdisc, jcfg, lpips_apply=jlpips))
    jstate = jt.create_vae_train_state(vparams, dparams, jcfg)
    tae, tds = tt.make_vae_train_steps(
        vae, disc, tcfg, lpips_apply=port_lpips.requires_grad_(False))
    tstate = tt.create_vae_train_state(vae, disc, tcfg)
    video = rng.uniform(-1, 1, (1, 3, 3, 16, 16)).astype(np.float32)
    jbatch, tbatch = {"video": _cl(video)}, {"video": torch.from_numpy(video)}
    mean_shape = (1, 2, 8, 8, JAX_TINY.latent_channels)  # B, T', H', W', C

    def noise(key):
        return torch.from_numpy(np.moveaxis(np.asarray(
            jax.random.normal(key, mean_shape)), -1, 1).copy())

    for i in range(1):
        k_ae, k_d = jax.random.PRNGKey(10 + i), jax.random.PRNGKey(20 + i)
        jstate, jaux = jae(jstate, jbatch, k_ae)
        tstate, taux = tae(tstate, tbatch, noise=noise(k_ae))
        jstate, jdaux = jds(jstate, jbatch, k_d)
        tstate, tdaux = tds(tstate, tbatch, noise=noise(k_d))
        assert set(taux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(_np(taux[k]), np.asarray(jaux[k]),
                                       rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(tdaux["disc_loss"]),
                                   np.asarray(jdaux["disc_loss"]),
                                   rtol=LOSS_RTOL)
        assert float(taux["d_weight"]) > 0 and tstate.step == i + 1
    jsd = jmagvit_export(jstate.vae_params)
    for n, p in vae.state_dict().items():
        np.testing.assert_allclose(_np(p), jsd[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
    jema = jmagvit_export(jstate.ema_params)
    for n, e in tstate.ema_params.items():
        np.testing.assert_allclose(_np(e), jema[n], rtol=0, atol=PARAM_ATOL,
                                   err_msg=n)
    for n, p in tl.state_dict_from_flax(jstate.disc_params).items():
        np.testing.assert_allclose(_np(disc.state_dict()[n]), _np(p), rtol=0,
                                   atol=PARAM_ATOL, err_msg=n)


def jmagvit_export(params):
    return jconvert.export_vae_state_dict(params, JAX_TINY)
