"""Parity of the port's V1-V3 editions with the JAX package: K1's plain
version at head dims 72 and 144, the motion modules (Temporal_Self with
and without the grid, Global_Self), the Transformer3D (V1's, V2's and V3's
block types over the four patch modes; V3 with the U-ViT skips and a text
mask), the kl2d VAE from one diffusers-keyed dict, V2's slice_mag protocol
at mini_batch 9 / 3, the T2V pipeline on a tiny V3 and the PixArt
pipeline, the three yamls, and the traps JAX's model sets (one
test_trap_* each).

The Transformer3D tests draw the port's random weights (every tensor
perturbed, so norms, biases and the zero-initialised linears are
exercised) and hand JAX the same values as its tree (flax_params, the
inverse of transformer3d_state_dict_from_jax: a JAX init traces for
seconds here), and the port takes that tree back through the converter.
The motion-module and pipeline tests go JAX-first: the trees JAX's inits
trace (jax.eval_shape) filled from numpy draws, read by the port through
transformer3d_state_dict_from_jax (strict=True). The VAEs: the port's
random weights, read by JAX's converters. Both packages run in float32 on the CPU from the same numpy
inputs. Tolerances are the tiny models' (test_torch_mmdit.py,
test_torch_pipeline.py) and the attention's (test_torch_ops.py).
"""
import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models import transformer3d_legacy as jl
from easyanimate_tpu.models.vae import kl2d as jkl2d
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.ops.attention import attention_xla
from easyanimate_tpu.pipeline import pixart as jpixart
from easyanimate_tpu.pipeline import t2v as jt2v
from easyanimate_tpu.pipeline.schedulers import DDIMConfig as JaxDDIM
from easyanimate_tpu.utils import config as jconfig
from easyanimate_tpu_torch.models import hunyuan as th
from easyanimate_tpu_torch.models import transformer3d_legacy as tl
from easyanimate_tpu_torch.models.convert import (
    kl2d_state_dict_from_jax, transformer3d_state_dict_from_jax)
from easyanimate_tpu_torch.models.vae import AutoencoderKL, AutoencoderKLMagvit
from easyanimate_tpu_torch.models.vae import kl2d as tkl2d
from easyanimate_tpu_torch.models.vae import magvit as tmagvit
from easyanimate_tpu_torch.ops import attention as tattn
from easyanimate_tpu_torch.pipeline import (DDIMConfig,
                                            EasyAnimateControlPipeline,
                                            EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline,
                                            PixArtMagvitPipeline)
from easyanimate_tpu_torch.utils import config as tconfig
from tests.test_torch_mmdit import MODEL_TOL
from tests.test_torch_ops import ATTN_TOL
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_serving import _random_weights
from tests.test_torch_vae import port_vae_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = {v: os.path.join(REPO, "config", name) for v, name in (
    ("v1", "easyanimate_video_v1_motion_module.yaml"),
    ("v2", "easyanimate_video_v2_magvit_motion_module.yaml"),
    ("v3", "easyanimate_video_v3_slicevae_motion_module.yaml"))}
TEXT, CAPTION = 6, 24
MM = jl.MotionModuleConfig
# the three editions' motion modules at 2 heads: V1's VanillaGrid (2 x 2
# cells), V2's Vanilla, V3's Temporal_Self / Global_Self by parity
BLOCKS = {
    "v1": ("motionmodule", MM(num_attention_heads=2, block_size=2, grid=True),
           MM(num_attention_heads=2, block_size=2, grid=True)),
    "v2": ("motionmodule", MM(num_attention_heads=2), MM(num_attention_heads=2)),
    "v3": ("global_motionmodule", MM(num_attention_heads=2),
           MM(num_attention_heads=2,
              attention_block_types=("Temporal_Self", "Global_Self")))}
PATCH = {"2d": {}, "3d": dict(time_patch_size=2), "fake_3d": {},
         "casual_3d": dict(time_patch_size=2, casual_3d_upsampler_index=(0,))}


def jax_cfg(edition, patch_mode="2d", **kw):
    btype, even, odd = BLOCKS[edition]
    return jl.Transformer3DConfig(**{
        **dict(num_attention_heads=2, attention_head_dim=16, num_layers=2,
               caption_channels=CAPTION, basic_block_type=btype,
               motion_module_even=even, motion_module_odd=odd,
               patch_mode=patch_mode, dtype="float32"),
        **PATCH[patch_mode], **kw})


def port_cfg(jcfg) -> tl.Transformer3DConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(tl.Transformer3DConfig)}
    for side in ("motion_module_even", "motion_module_odd"):
        kw[side] = tl.MotionModuleConfig(**dataclasses.asdict(kw[side]))
    return tl.Transformer3DConfig(**kw)


def _t(a):
    return torch.from_numpy(np.array(a))


def _draw(path, shape, rng):
    """A value for JAX's parameter at `path`: N(0, 1 / fan_in) for a
    kernel, 1 + N(0, 0.05^2) for a norm scale, N(0, 0.1^2) otherwise."""
    x = rng.standard_normal(shape).astype(np.float32)
    if path[-1] == "kernel":
        return x / np.sqrt(np.prod(shape[:-1]))
    if path[-1].endswith("scale"):
        return 1.0 + 0.05 * x
    return 0.1 * x


def jax_params(init, seed, *args):
    """The parameter tree `init` traces on `args`, filled from numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda *a: init(jax.random.PRNGKey(0), *a), *args)
    flat = flax.traverse_util.flatten_dict(shapes)
    return flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_draw(k, v.shape, rng)) for k, v in flat.items()})


def flax_params(port: torch.nn.Module):
    """The port's parameters as JAX's tree (the inverse of
    transformer3d_state_dict_from_jax; every `weight` of these modules is a
    Dense or conv kernel), so no JAX init is traced."""
    tree = {}
    for name, p in port.state_dict().items():
        path = name.split(".")
        if path[0] == "blocks":
            path = [f"block{path[1]}"] + path[2:]
        a = p.numpy()
        if path[-1] == "weight":
            path[-1] = "kernel"
            a = a.transpose({2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0),
                             5: (2, 3, 4, 1, 0)}[a.ndim])
        tree[tuple(path)] = jnp.asarray(np.ascontiguousarray(a))
    return {"params": flax.traverse_util.unflatten_dict(tree)}


def model_pair(jcfg, seed=0):
    """The port's model for jcfg with random weights (every tensor
    perturbed, so norms, biases and zero-initialised linears are
    exercised), JAX's model and the same params as its tree; the port also
    loads that tree back through transformer3d_state_dict_from_jax."""
    port = tl.Transformer3D(port_cfg(jcfg), device="cpu")
    _random_weights(port, seed)
    params = flax_params(port)
    port.load_state_dict(transformer3d_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jl.Transformer3D(jcfg), params, port.eval()


def _inputs(frames, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, frames, 8, 8)).astype(np.float32),
            np.array([500.0, 20.0], np.float32),
            rng.standard_normal((2, TEXT, CAPTION)).astype(np.float32))


@pytest.mark.parametrize("d,sq,skv,kv_valid", [
    (72, 36, 36, None), (72, 100, 77, 70), (144, 36, 36, None),
    (144, 64, 50, 41), (144, 64, 64, None), (72, 200, 120, None)])
def test_attention_at_head_dims_72_and_144_matches_jax(d, sq, skv, kv_valid):
    """The port's attention (K1's plain version on the CPU) at the V1-V3
    head dims against JAX's attention_xla: the temporal passes' 36 and 64
    tokens (V1's grid at 64), the text pass's 120 keys, and ragged kv
    lengths with the columns past kv_valid hidden."""
    rng = np.random.default_rng(d + sq)
    q, k, v = (rng.standard_normal((2, 3, n, d)).astype(np.float32)
               for n in (sq, skv, skv))
    want = attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         kv_valid=kv_valid)
    got = tattn.attention(_t(q), _t(k), _t(v), kv_valid=kv_valid)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("mm", [
    MM(num_attention_heads=2, block_size=2, grid=True),
    MM(num_attention_heads=2, num_transformer_block=2),
    MM(num_attention_heads=4,
       attention_block_types=("Temporal_Self", "Global_Self"))],
    ids=["grid", "temporal", "global"])
def test_motion_module_matches_jax(mm):
    """A MotionModule alone over 3 frames of 4 x 4 tokens: V1's 2 x 2 grid
    cells, V2's Temporal_Self (two transformer blocks), V3's Global_Self;
    its zero-initialised proj_out drawn non-zero so the branch shows."""
    dim, f, h, w = 32, 3, 4, 4
    x = np.random.default_rng(2).standard_normal((2, f * h * w, dim)).astype(
        np.float32)
    module = jl.MotionModule(dim, mm)
    params = jax_params(lambda key, a: module.init(key, a, f, h, w), 3, x)
    want = jax.jit(lambda p, a: module.apply(p, a, f, h, w))(params, x)
    port = tl.MotionModule(dim, tl.MotionModuleConfig(**dataclasses.asdict(mm)),
                           device="cpu", dtype=torch.float32)
    port.load_state_dict(transformer3d_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = port(_t(x), f, h, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.mark.parametrize("patch_mode", list(PATCH))
@pytest.mark.parametrize("edition", ["v1", "v2", "v3"])
def test_transformer3d_matches_jax(edition, patch_mode):
    """The whole forward for each edition's block type and each patch mode
    (V3 at 2 layers for its even and odd motion modules, V1 and V2 at 1,
    their two being alike; casual_3d with its upsampler before layer 0, 5
    frames -> 3 tokens a position -> 5)."""
    frames = 5 if patch_mode == "casual_3d" else 4
    lat, t, txt = _inputs(frames)
    jcfg = jax_cfg(edition, patch_mode, num_layers=2 if edition == "v3" else 1)
    model, params, port = model_pair(jcfg)
    want = jax.jit(model.apply)(params, lat, t, txt, None)
    with torch.no_grad():
        got = port(_t(lat), _t(t), _t(txt))
    assert got.shape == (2, 8, frames, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


def test_transformer3d_uvit_skips_text_mask_and_qk_norm_match_jax():
    """16 layers, so that layer 15 pops the skip pushed after layer 12
    through long_connect_fc0; the text mask's bias path (plain einsums);
    qk_norm and after_norm on. Basic blocks: the motion modules are the
    other tests', and 16 of them compile for 10 s in JAX."""
    lat, t, txt = _inputs(3)
    jcfg = jax_cfg("v3", num_layers=16, qk_norm=True, after_norm=True,
                   basic_block_type="basic")
    model, params, port = model_pair(jcfg, seed=5)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.float32)
    want = jax.jit(model.apply)(params, lat, t, txt, None, mask)
    with torch.no_grad():
        got = port(_t(lat), _t(t), _t(txt), text_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    assert [n for n, _ in port.named_children()
            if n.startswith("long_connect_fc")] == ["long_connect_fc0"]


TINY_KL2D = jkl2d.KL2DConfig(block_out_channels=(8, 16), layers_per_block=1,
                             norm_num_groups=4)


def test_kl2d_encode_decode_match_jax_from_one_diffusers_dict():
    """One diffusers-keyed AutoencoderKL dict (the port's random weights):
    JAX reads it through convert_kl2d_state_dict, the port with strict=True;
    encode and decode of 3 frames agree, and kl2d_state_dict_from_jax
    carries JAX's tree back to the same dict."""
    port = AutoencoderKL(tkl2d.KL2DConfig(**dataclasses.asdict(TINY_KL2D)),
                         device="cpu")
    sd = _random_weights(port, 3)
    params = jkl2d.convert_kl2d_state_dict(sd, TINY_KL2D)
    back = kl2d_state_dict_from_jax(params)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    port.load_state_dict({k: _t(v) for k, v in sd.items()}, strict=True)
    jvae = jkl2d.AutoencoderKL(TINY_KL2D)
    rng = np.random.default_rng(4)
    video = rng.uniform(-1, 1, (1, 3, 3, 16, 16)).astype(np.float32)
    z = rng.standard_normal((1, 4, 3, 8, 8)).astype(np.float32)
    moments_j, video_j = jax.jit(lambda p: (
        jmagvit.vae_encode(jvae, {"params": p}, video),
        jmagvit.vae_decode(jvae, {"params": p}, z)))(params)
    with torch.no_grad():
        moments = tmagvit.vae_encode(port, _t(video))
        decoded = tmagvit.vae_decode(port, _t(z))
    assert moments.shape == (1, 8, 3, 8, 8)
    assert decoded.shape == (1, 3, 3, 16, 16)
    np.testing.assert_allclose(moments.numpy(), np.asarray(moments_j),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(video_j),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    for f in (1, 16, 49):
        assert (tmagvit.latent_frame_count(f, port.cfg)
                == jmagvit.latent_frame_count(f, TINY_KL2D) == f)
    with pytest.raises(TypeError, match="AutoencoderKL"):
        tmagvit.vae_decode_tiled(port, moments[:, :2])


# V2's slice_mag protocol (mini_batch 9 / 3) on a tiny 2-block MagViT
# (temporal compression 2)
V2_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=9,
    mini_batch_decoder=3, scaling_factor=0.5, chunk_mode="slice_mag")


@pytest.fixture(scope="module")
def v2_vae():
    vae = AutoencoderKLMagvit(port_vae_cfg(V2_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0), V2_VAE)
    return jmagvit.AutoencoderKLMagvit(V2_VAE), vparams, vae.eval()


def test_v2_slice_mag_at_mini_batch_9_and_3_matches_jax(v2_vae):
    """V2's VAE kwargs, which no other ported config sets: the frame remap
    at several lengths, then the encode of 18 frames (two independent
    9-frame chunks) and the decode of 7 latents (3 + 3 + 1 a chunk)."""
    jvae, vparams, vae = v2_vae
    for f in (1, 9, 17, 18, 49, 144):
        assert (tmagvit.latent_frame_count(f, vae.cfg)
                == jmagvit.latent_frame_count(f, V2_VAE))
    rng = np.random.default_rng(7)
    video = rng.uniform(-1, 1, (1, 3, 18, 8, 8)).astype(np.float32)
    z = rng.standard_normal((1, 4, 7, 4, 4)).astype(np.float32)
    moments_j, decoded_j = jax.jit(lambda p: (
        jmagvit.vae_encode(jvae, p, video), jmagvit.vae_decode(jvae, p, z)))(
        vparams)
    with torch.no_grad():
        moments = tmagvit.vae_encode(vae, _t(video))
        decoded = tmagvit.vae_decode(vae, _t(z))
    assert moments.shape[2] == moments_j.shape[2] == 10
    assert decoded.shape[2] == decoded_j.shape[2] == 11
    np.testing.assert_allclose(moments.numpy(), np.asarray(moments_j),
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(decoded.numpy(), np.asarray(decoded_j),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def _prompts(seed):
    pos = np.random.default_rng(seed).standard_normal(
        (1, TEXT, CAPTION)).astype(np.float32)
    return pos, np.zeros_like(pos)


def test_v3_t2v_and_pixart_pipelines_match_jax(v2_vae):
    """A tiny V3 through EasyAnimatePipeline on V2_VAE, and its
    Transformer2D through PixArtMagvitPipeline (video_length 1) on the same
    MagViT in the cache_mag protocol (slice_mag maps 1 frame to 0 latents
    in both packages; JAX's own PixArt test runs a cache_mag MagViT), 2
    DDIM steps under CFG 6 on the same noise: the latents against JAX's;
    TeaCache stays off (no V1-V3 polynomial); the port's image comes back
    (B, 3, H, W)."""
    jvae, vparams, vae = v2_vae
    cache = dataclasses.replace(V2_VAE, chunk_mode="cache_mag",
                                mini_batch_encoder=4, mini_batch_decoder=1)
    assert (tmagvit.latent_frame_count(1, vae.cfg)
            == jmagvit.latent_frame_count(1, V2_VAE) == 0)
    cache_vae = AutoencoderKLMagvit(port_vae_cfg(cache), device="cpu")
    _random_weights(cache_vae, 1)
    h = w = 16
    jcfg = jax_cfg("v3")
    lat_in, _, txt_in = _inputs(2)
    pos, neg = _prompts(8)
    kw = dict(height=h, width=w, num_inference_steps=2, guidance_scale=6.0,
              output_type="latent")
    for pipe_cls, jpipe_cls, model_fn, jmodel_fn, frames, vaes in (
            (EasyAnimatePipeline, jt2v.EasyAnimatePipeline, tl.Transformer3D,
             jl.Transformer3D, 18, (vae, jvae)),
            (PixArtMagvitPipeline, jpixart.PixArtMagvitPipeline,
             tl.Transformer2D, jl.Transformer2D, 1,
             (cache_vae.eval(), jmagvit.AutoencoderKLMagvit(cache)))):
        model = jmodel_fn(jcfg)
        params = jax_params(model.init, 9, lat_in,
                            np.array([1.0, 2.0], np.float32), txt_in, None)
        port = model_fn(port_cfg(jcfg), device="cpu")
        port.load_state_dict(transformer3d_state_dict_from_jax(
            jax.tree.map(np.asarray, params)))
        pipe = pipe_cls(port.eval(), vaes[0], "cpu", scheduler=DDIMConfig())
        jpipe = jpipe_cls(transformer=model, vae=vaes[1],
                          transformer_params=params, vae_params=vparams,
                          scheduler=JaxDDIM())
        shape = pipe.latent_shape(1, frames, h, w)
        lat0 = np.random.default_rng(10).standard_normal(shape).astype(
            np.float32)
        video = {} if frames == 1 else dict(video_length=frames)
        lat_j = np.asarray(jpipe(jnp.asarray(pos), jnp.asarray(neg),
                                 latents=jnp.asarray(lat0), **video, **kw))
        lat = pipe(_t(pos), _t(neg), latents=_t(lat0), teacache_threshold=0.1,
                   **video, **kw)
        assert lat.shape == shape and pipe.last_teacache_skips is None
        np.testing.assert_allclose(lat.numpy(), lat_j, atol=LATENT_TOL,
                                   rtol=LATENT_TOL)
    assert shape[2] == 1
    image = pipe(_t(pos), _t(neg), height=h, width=w, num_inference_steps=1,
                 guidance_scale=6.0, latents=_t(lat0))
    assert image.shape == (1, 3, h, w) and image.dtype == np.float32


def _fields(cfg):
    """A config's fields, its motion modules' lists as tuples."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = {k: tuple(x) if isinstance(x, list) else x
                 for k, x in dataclasses.asdict(v).items()}
        out[f.name] = v
    return out


@pytest.mark.parametrize("edition", ["v1", "v2", "v3"])
def test_yamls_build_the_port_modules_with_jax_fields(edition):
    """build_transformer and build_vae from each V1-V3 yaml: the port's
    Transformer3D and VAE with JAX's config fields (V1: VanillaGrid with
    2 x 2 cells, 8 heads of 144 in the motion modules, the 2D VAE; V2:
    slice_mag at 9 / 3; V3: 16 heads of 72 and Global_Self on odd layers)."""
    yml = tconfig.load_yaml_config(YAMLS[edition])
    model, cfg = tconfig.build_transformer(yml, device="meta")
    _, jcfg = jconfig.build_transformer(yml)
    assert isinstance(model, tl.Transformer3D)
    assert _fields(cfg) == _fields(jcfg)
    assert next(model.parameters()).device.type == "meta"
    heads = {"v1": 8, "v2": 8, "v3": 16}[edition]
    assert cfg.motion_module_odd.num_attention_heads == heads
    assert cfg.motion_module_even.grid == (edition == "v1")
    vae, vcfg = tconfig.build_vae(yml, device="meta")
    _, jvcfg = jconfig.build_vae(yml)
    assert {f.name: getattr(vcfg, f.name) for f in dataclasses.fields(vcfg)} \
        == {f.name: getattr(jvcfg, f.name) for f in dataclasses.fields(vcfg)}
    assert isinstance(vae, AutoencoderKL if edition == "v1"
                      else AutoencoderKLMagvit)


@pytest.mark.parametrize("edition", ["v1", "v2", "v3"])
def test_chip_smoke_legacy_yaml_matches_the_yamls(edition):
    """chip_smoke.py writes the V1-V3 yamls' transformer_additional_kwargs
    and vae_kwargs out by hand (the card has no yaml reader): they must be
    the yamls' own, so that its full-size phases run these configurations."""
    import chip_smoke
    yml = tconfig.load_yaml_config(YAMLS[edition])
    t_kw, v_kw = chip_smoke.LEGACY_YAML[edition]
    assert dict(yml["transformer_additional_kwargs"]) == t_kw
    assert dict(yml["vae_kwargs"]) == v_kw


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret"])
@pytest.mark.parametrize("transformer_type",
                         ["Transformer3DModel", "HunyuanTransformer3DModel"])
def test_trap_attn_impl_other_than_auto_is_refused(transformer_type, impl):
    """JAX's Transformer3DConfig and HunyuanConfig carry attn_impl and read
    it nowhere; the port keeps the field for the same field set, runs every
    attention on K1, and refuses any other setting rather than ignore it."""
    kw = {"transformer_type": transformer_type, "attn_impl": impl}
    with pytest.raises(ValueError, match="only 'auto'"):
        tconfig.build_transformer(kw, device="meta")
    cls = (tl.Transformer3DConfig if transformer_type == "Transformer3DModel"
           else th.HunyuanConfig)
    with pytest.raises(ValueError, match="only 'auto'"):
        cls(attn_impl=impl)
    assert cls().attn_impl == "auto"


def test_trap_norm_eps_split(monkeypatch):
    """The motion modules' LayerNorms take fp32_layer_norm's default eps
    (1e-5); the block's two modulated norms, after_norm, qk_norm and the
    output norm take 1e-6. Every call of a tiny V3 layer pair is
    recorded: 4 per motion module (its input, its two attention blocks,
    its feed-forward) at 1e-5; the rest at 1e-6."""
    calls = []
    real = tl.fp32_layer_norm

    def spy(x, weight=None, bias=None, eps=1e-5):
        calls.append(eps)
        return real(x, weight, bias, eps)

    monkeypatch.setattr(tl, "fp32_layer_norm", spy)
    lat, t, txt = _inputs(2)
    port = tl.Transformer3D(port_cfg(jax_cfg("v3", qk_norm=True,
                                             after_norm=True)), device="cpu")
    with torch.no_grad():
        port(_t(lat), _t(t), _t(txt))
    # per layer: 2 modulated + 1 after_norm + 2 q/k norms in each of attn1,
    # attn2 and the motion module's two attentions... which take no qk_norm
    assert calls.count(1e-5) == 2 * 4
    assert calls.count(1e-6) == 2 * (2 + 1 + 2 * 2) + 1
    assert len(calls) == calls.count(1e-5) + calls.count(1e-6)


def test_trap_v1_enable_uvit_defaults_true():
    """V1's yaml leaves enable_uvit unset, so it takes JAX's default, True:
    the 28-layer model has long_connect_fc0-12, zero-initialised as the
    motion modules' proj_out are."""
    yml = tconfig.load_yaml_config(YAMLS["v1"])
    assert "enable_uvit" not in yml["transformer_additional_kwargs"]
    _, cfg = tconfig.build_transformer(yml, device="meta")
    _, jcfg = jconfig.build_transformer(yml)
    assert cfg.enable_uvit and jcfg.enable_uvit
    port = tl.Transformer3D(dataclasses.replace(
        cfg, num_layers=16, num_attention_heads=2, attention_head_dim=16,
        caption_channels=CAPTION, dtype="float32",
        motion_module_even=dataclasses.replace(cfg.motion_module_even,
                                               num_attention_heads=2),
        motion_module_odd=dataclasses.replace(cfg.motion_module_odd,
                                              num_attention_heads=2)),
        device="cpu")
    assert port.n_skips == 1 and tl.Transformer3D(cfg, device="meta").n_skips == 13
    zero = [port.long_connect_fc0] + [b.attn_temporal.proj_out
                                      for b in port.blocks]
    assert all(float(m.weight.detach().abs().max()) == 0.0 for m in zero)


def test_trap_inpaint_and_control_refuse_transformer3d(v2_vae):
    """JAX's inpaint pipeline reads resize_inpaint_mask_directly and
    add_noise_in_inpaint_model from the transformer's config, its control
    pipeline add_ref_latent_in_control_model, and Transformer3DConfig has
    none of them: no V1-V3 I2V or control in JAX, so the port's pipelines
    refuse a Transformer3D by name."""
    jcfg = jax_cfg("v2")
    assert not any(hasattr(jcfg, f) for f in (
        "resize_inpaint_mask_directly", "add_noise_in_inpaint_model",
        "add_ref_latent_in_control_model"))
    port = tl.Transformer3D(port_cfg(jcfg), device="cpu")
    with pytest.raises(NotImplementedError, match="add_noise_in_inpaint"):
        EasyAnimateInpaintPipeline(port, v2_vae[2], "cpu")
    with pytest.raises(NotImplementedError, match="add_ref_latent"):
        EasyAnimateControlPipeline(port, v2_vae[2], "cpu")
