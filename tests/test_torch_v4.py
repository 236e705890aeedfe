"""Parity of the port's V4 edition with the JAX package: K1's plain version
at head dim 88, the 2D RoPE, the HunyuanDiT-3D transformer (basic and
kvcompression_basic, with text masks and the CLIP-image branch), the
slice_mag MagViT with smooth_output, the T2V pipeline under DDIM and CFG
(with its smoothed decode), the I2V pipeline's CLIP gate, the V4 yaml, and
the traps JAX's model sets (one test_trap_* each).

One tiny HunyuanDiT (2 heads x 88, 4 layers, so that both skip halves
exist; time_position_encoding on) takes JAX's kvcompression_basic
parameter tree, as its init traces it (jax.eval_shape: a jitted init
compiles for 11 s here), filled from numpy draws scaled as the
initialisers are, with the norms and biases off their defaults so they are
exercised; `basic` drops the decoder half's compression convs, and the I2V
variant swaps in a 12-channel patchify. The port loads them through
hunyuan_state_dict_from_jax with strict=True. Both packages run in float32
on the CPU from the same numpy inputs; T2V at 32x32x10f on a 2-block
slice_mag MagViT (the port's random weights crossed to JAX), 5 latent
frames decoding to 7, whose smoothing re-decode is 3 frames long; I2V at
32x32x4f (one slice chunk: JAX's inpaint pipeline encodes op by op).
Tolerances are the tiny models' (test_torch_mmdit.py, test_torch_pipeline
.py) and the attention's (test_torch_ops.py).
"""
import dataclasses
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models import hunyuan as jh
from easyanimate_tpu.models.mmdit import _sincos_2d
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.ops import rope as jrope
from easyanimate_tpu.ops.attention import attention as jax_attention
from easyanimate_tpu.pipeline import inpaint as jinpaint
from easyanimate_tpu.pipeline import t2v as jt2v
from easyanimate_tpu.pipeline.schedulers import DDIMConfig as JaxDDIM
from easyanimate_tpu.utils import config as jconfig
from easyanimate_tpu_torch.models import hunyuan as th
from easyanimate_tpu_torch.models.convert import hunyuan_state_dict_from_jax
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.models.vae import magvit as tmagvit
from easyanimate_tpu_torch.ops import attention as tattn
from easyanimate_tpu_torch.ops import rope as trope
from easyanimate_tpu_torch.pipeline import (DDIMConfig,
                                            EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline)
from easyanimate_tpu_torch.pipeline import t2v as tt2v
from easyanimate_tpu_torch.utils import config as tconfig
from easyanimate_tpu_torch.utils.media import get_image_to_video_latent
from tests.test_torch_mmdit import MODEL_TOL
from tests.test_torch_ops import ATTN_TOL
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_vae import port_vae_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V4_YAML = os.path.join(REPO, "config",
                       "easyanimate_video_v4_slicevae_multi_text_encoder.yaml")
TEXT, TEXT_T5, CLIP_N = 6, 4, 25  # CLIP: 5 x 5 patches against 4 x 4 queries
JCFG = jh.HunyuanConfig(
    num_attention_heads=2, attention_head_dim=88, num_layers=4,
    cross_attention_dim=32, cross_attention_dim_t5=24,
    pooled_projection_dim=32, text_len=TEXT, text_len_t5=TEXT_T5,
    time_position_encoding=True, basic_block_type="kvcompression_basic",
    dtype="float32")
JCFG_I2V = dataclasses.replace(JCFG, basic_block_type="basic",
                               in_channels=12, out_channels=8)
# V4's slice_mag protocol on the tiny 2-block MagViT: 4 pixel frames (2
# latents) a chunk, as V4's 8 (temporal compression 4) are
V4_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=4,
    mini_batch_decoder=2, scaling_factor=0.5, chunk_mode="slice_mag")
H = W = 32
FRAMES, I2V_FRAMES, STEPS = 10, 4, 3


def port_cfg(jcfg) -> th.HunyuanConfig:
    return th.HunyuanConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(th.HunyuanConfig)})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draw(path, shape, rng):
    """A value for JAX's parameter at `path`: N(0, 1 / fan_in) for a
    kernel, 1 + N(0, 0.05^2) for a norm scale, N(0, 0.1^2) otherwise."""
    x = rng.standard_normal(shape).astype(np.float32)
    if path[-1] == "kernel":
        return x / np.sqrt(np.prod(shape[:-1]))
    if path[-1].endswith("scale"):
        return 1.0 + 0.05 * x
    return 0.1 * x


def _basic(params):
    """kvcompression_basic's tree without the compression convs: basic's."""
    flat = flax.traverse_util.flatten_dict(params)
    return flax.traverse_util.unflatten_dict(
        {k: v for k, v in flat.items()
         if not any("compression" in p for p in k)})


def _port_model(jcfg, params):
    model = th.HunyuanTransformer3D(port_cfg(jcfg), device="cpu")
    model.load_state_dict(hunyuan_state_dict_from_jax(_np(params)))
    return model.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def v4():
    """JAX's tiny kvcompression_basic parameters (the tree its init traces
    on these inputs, numpy values), the inputs, and the port's three models
    (kvcompression_basic, basic, the I2V variant)."""
    rng = np.random.default_rng(0)
    ins = {"lat": rng.standard_normal((2, 4, 3, 8, 8)),
           "t": np.array([500.0, 20.0]),
           "txt": rng.standard_normal((2, TEXT, 32)),
           "t5": rng.standard_normal((2, TEXT_T5, 24)),
           "clip": rng.standard_normal((2, CLIP_N, 32)),
           "mask": (rng.random((2, TEXT)) > 0.3),
           "mask_t5": (rng.random((2, TEXT_T5)) > 0.3),
           "clip_mask": np.arange(16)[None] < np.array([[16], [10]])}
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    rope = jt2v.build_rope(JCFG, 64, 64, 3)
    model = jh.HunyuanTransformer3D(JCFG)
    shapes = jax.eval_shape(lambda *a: model.init(
        jax.random.PRNGKey(0), *a, encoder_hidden_states_t5=ins["t5"],
        clip_encoder_hidden_states=ins["clip"],
        clip_attention_mask=ins["clip_mask"]),
        ins["lat"], ins["t"], ins["txt"], rope)
    flat = flax.traverse_util.flatten_dict(shapes)
    params = flax.traverse_util.unflatten_dict(
        {k: jnp.asarray(_draw(k, v.shape, rng)) for k, v in flat.items()})
    i2v = flax.core.unfreeze(_basic(params))
    i2v["params"]["pos_embed_proj"]["kernel"] = jnp.asarray(
        rng.standard_normal((2, 2, 12, JCFG.inner_dim)).astype(np.float32)
        * 0.1)
    return {"params": params, "ins": ins, "rope": rope,
            "port": {"kvcompression_basic": _port_model(JCFG, params),
                     "basic": _port_model(
                         dataclasses.replace(JCFG, basic_block_type="basic"),
                         _basic(params)),
                     "i2v": _port_model(JCFG_I2V, i2v)},
            "i2v_params": i2v}


def test_k1_plain_at_head_dim_88_matches_pallas_interpret(rng):
    """K1's plain version at d 88 against JAX's Pallas forward in interpret
    mode: 200 queries over 333 keys, whose last 128-row kv block is
    ragged."""
    q, k, v = (rng.standard_normal((1, 2, n, 88)).astype(np.float32)
               for n in (200, 333, 333))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         impl="pallas_interpret", block_q=128, block_kv=128,
                         block_kv_inner=128)
    got = tattn.attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


@pytest.mark.parametrize("hw", [(512, 512), (384, 672), (64, 64)])
def test_2d_rope_matches_jax(hw):
    """get_2d_rotary_pos_embed and build_rope's 2d_rope branch: a crop of
    the 512 // s base grid, single-frame tables."""
    crop = trope.get_resize_crop_region_for_grid((hw[0] // 16, hw[1] // 16),
                                                 32, 32)
    for got, want in zip(trope.get_2d_rotary_pos_embed(
            88, crop, (hw[0] // 16, hw[1] // 16)),
            jrope.get_2d_rotary_pos_embed(88, crop, (hw[0] // 16, hw[1] // 16))):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tt2v.build_rope(JCFG, *hw, 7, device="cpu"),
                         jt2v.build_rope(JCFG, *hw, 7)):
        assert got.shape == (hw[0] // 16 * hw[1] // 16, 88)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["basic", "kvcompression_basic"])
def test_tiny_transformer_matches_jax(v4, kind):
    """The whole forward with both text masks (the padding table) and the
    CLIP branch (25 patch states into 16 queries: the bicubic table, and a
    mask that pads the last 6). The pipelines run it without the CLIP
    states and the masks (test_t2v_...)."""
    params = v4["params"] if kind == "kvcompression_basic" else _basic(
        v4["params"])
    cfg = dataclasses.replace(JCFG, basic_block_type=kind)
    ins, rope = v4["ins"], v4["rope"]
    kw = dict(encoder_hidden_states_t5=ins["t5"],
              text_embedding_mask=ins["mask"],
              text_embedding_mask_t5=ins["mask_t5"],
              clip_encoder_hidden_states=ins["clip"],
              clip_attention_mask=ins["clip_mask"])
    want = jax.jit(jh.HunyuanTransformer3D(cfg).apply)(
        params, ins["lat"], ins["t"], ins["txt"], rope, **kw)
    with torch.no_grad():
        got = v4["port"][kind](_t(ins["lat"]), _t(ins["t"]), _t(ins["txt"]),
                               tuple(_t(r) for r in rope),
                               **{k: _t(v) for k, v in kw.items()})
    assert got.shape == (2, 8, 3, 8, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)


@pytest.fixture(scope="module")
def vae_pair():
    """V4_VAE in both packages: the port's random weights, read by JAX's
    converter."""
    from tests.test_torch_serving import _random_weights

    vae = AutoencoderKLMagvit(port_vae_cfg(V4_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0), V4_VAE)
    return jmagvit.AutoencoderKLMagvit(V4_VAE), vparams, vae


def test_slice_mag_vae_and_smooth_output_match_jax(vae_pair):
    """slice_mag encode (independent 4-frame chunks) against JAX's, the
    slice frame count, and decode (2-latent chunks) and smooth_output on
    the port: the frame counts, the blended middle and the untouched ends.
    Their values against JAX's are test_t2v_...'s decoded video, which
    JAX's decode_latents smooths (one compile for both)."""
    jvae, vparams, vae = vae_pair
    assert vae.cfg.chunk_mode == "slice_mag"
    for f in (5, 8, 10, 16, 49):
        assert (tmagvit.latent_frame_count(f, vae.cfg)
                == jmagvit.latent_frame_count(f, V4_VAE) == f // 2)
    video = np.random.default_rng(1).uniform(
        -1, 1, (1, 3, FRAMES, 16, 16)).astype(np.float32)

    moments_j = jax.jit(lambda p, x: jmagvit.vae_encode(jvae, p, x))(
        vparams, video)
    with torch.no_grad():
        moments = tmagvit.vae_encode(vae, _t(video))
        np.testing.assert_allclose(moments.numpy(), np.asarray(moments_j),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        z = tmagvit.gaussian_mode(moments)
        assert z.shape[2] == FRAMES // 2
        got = tmagvit.vae_decode(vae, z)
        # 2 + 2 + 1 latents -> 3 + 3 + 1 frames (each chunk's first frame
        # is not doubled)
        assert got.shape[2] == 7
        smoothed = tmagvit.smooth_output(vae, got)
        assert (smoothed[:, :, 2:-2] - got[:, :, 2:-2]).abs().max() > 1e-3
        torch.testing.assert_close(smoothed[:, :, :2], got[:, :, :2])
        short = got[:, :, :4]  # no longer than mini_batch_encoder: as it is
        assert tmagvit.smooth_output(vae, short) is short


def test_trap_smooth_output_needs_a_re_decode_of_the_middle_s_length(
        vae_pair):
    """JAX's smooth_output writes (middle + re-decode) / 2 back into the
    middle: a one-frame re-decode broadcasts, one of another length fails.
    A slice_mag chunk of 2 latents decodes to 3 frames here (5 with V4's
    two temporal ups), so the decode of 12 frames (6 latents) is 9 frames,
    whose middle 5 re-encode to 3 latents and re-decode to 4: the port
    raises there as JAX does, and blends the middle 2 of a 6-frame decode
    (8 frames, 4 latents) with their one re-decoded frame."""
    vae = vae_pair[2]
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for f, ok in ((6, True), (9, False)):
            video = _t(rng.uniform(-1, 1, (1, 3, f, 16, 16)).astype(np.float32))
            if ok:
                out = tmagvit.smooth_output(vae, video)
                mid = video[:, :, 2:-2]
                redec = tmagvit.vae_decode(vae, tmagvit.gaussian_mode(
                    tmagvit.vae_encode(vae, mid)))
                assert redec.shape[2] == 1
                torch.testing.assert_close(out[:, :, 2:-2], (mid + redec) / 2)
            else:
                with pytest.raises(RuntimeError, match="size"):
                    tmagvit.smooth_output(vae, video)


_PIPES = {}


def pipes(kind, v4, vae_pair):
    """(JAX pipeline, port pipeline) under DDIM: T2V on the basic model,
    I2V on the 12-channel variant."""
    if kind not in _PIPES:
        jvae, vparams, vae = vae_pair
        if kind == "t2v":
            jpipe = jt2v.EasyAnimatePipeline(
                transformer=jh.HunyuanTransformer3D(
                    dataclasses.replace(JCFG, basic_block_type="basic")),
                vae=jvae, transformer_params=_basic(v4["params"]),
                vae_params=vparams, scheduler=JaxDDIM())
            pipe = EasyAnimatePipeline(v4["port"]["basic"], vae, "cpu",
                                       scheduler=DDIMConfig())
        else:
            jpipe = jinpaint.EasyAnimateInpaintPipeline(
                transformer=jh.HunyuanTransformer3D(JCFG_I2V), vae=jvae,
                transformer_params=v4["i2v_params"], vae_params=vparams,
                scheduler=JaxDDIM())
            pipe = EasyAnimateInpaintPipeline(v4["port"]["i2v"], vae, "cpu",
                                              scheduler=DDIMConfig())
        _PIPES[kind] = jpipe, pipe
    return _PIPES[kind]


def _prompts(seed):
    rng = np.random.default_rng(seed)
    shapes = {"pos": (1, TEXT, 32), "pos_t5": (1, TEXT_T5, 24),
              "neg_t5": (1, TEXT_T5, 24)}
    ins = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    ins["neg"] = np.zeros_like(ins["pos"])
    return ins


def _kw(ins, wrap, frames=FRAMES):
    return dict(prompt_embeds_t5=wrap(ins["pos_t5"]),
                negative_prompt_embeds_t5=wrap(ins["neg_t5"]), height=H,
                width=W, video_length=frames, num_inference_steps=STEPS,
                guidance_scale=6.0, output_type="latent")


def test_t2v_ddim_cfg_and_smoothed_decode_match_jax(v4, vae_pair):
    """DDIM under CFG 6 on both prompt streams: the latents, the decoded
    video (slice_mag: smooth_output on by default, untiled at 32 px), and
    cfg_split's halves against the batched CFG; TeaCache stays off (no V4
    polynomial)."""
    jpipe, pipe = pipes("t2v", v4, vae_pair)
    ins = _prompts(3)
    lat0 = np.random.default_rng(4).standard_normal(
        pipe.latent_shape(1, FRAMES, H, W)).astype(np.float32)
    assert lat0.shape == (1, 4, 5, 16, 16)
    lat_j = np.asarray(jpipe(jnp.asarray(ins["pos"]), jnp.asarray(ins["neg"]),
                             latents=jnp.asarray(lat0), **_kw(ins, jnp.asarray)))
    lat = pipe(_t(ins["pos"]), _t(ins["neg"]), latents=_t(lat0),
               **_kw(ins, _t))
    np.testing.assert_allclose(lat.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    assert pipe.smooth_default() and jpipe.smooth_default()
    video = pipe.decode_latents(_t(lat_j))
    assert video.shape == (1, 3, 7, H, W)
    np.testing.assert_allclose(video, jpipe.decode_latents(jnp.asarray(lat_j)),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    assert np.abs(video - pipe.decode_latents(_t(lat_j), smooth=False)
                  ).max() > 1e-3
    split = pipe(_t(ins["pos"]), _t(ins["neg"]), latents=_t(lat0),
                 cfg_split=True, **_kw(ins, _t))
    np.testing.assert_allclose(split.numpy(), lat.numpy(), atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    assert pipe.teacache_coefficients is None
    again = pipe(_t(ins["pos"]), _t(ins["neg"]), latents=_t(lat0),
                 teacache_threshold=0.1, **_kw(ins, _t))
    assert pipe.last_teacache_skips is None and torch.equal(again, lat)


def test_i2v_clip_gate_opens_mid_schedule_and_matches_jax(v4, vae_pair,
                                                          monkeypatch):
    """I2V from a start frame with the CLIP states: the mask VAE-encoded
    (resize_inpaint_mask_directly off), zero states and mask for the
    unconditional half, and the gate at clip_apply_ratio 0.4 of 3 steps
    shut for steps 0 and 1 and open at step 2 (0.6 * 3 = 1.8). JAX's noise
    is its draw from its key, handed to the port; its pipeline's VAE
    encodes run jitted (op by op they compile for 4.5 s here)."""
    jpipe, pipe = pipes("i2v", v4, vae_pair)
    jvae, vparams = vae_pair[:2]
    encode = jax.jit(lambda p, x: jmagvit.vae_encode(jvae, p, x))
    monkeypatch.setattr(jinpaint, "vae_encode",
                        lambda vae, params, x: encode(params, x))
    ins = _prompts(5)
    shape = pipe.latent_shape(1, I2V_FRAMES, H, W)
    key = jax.random.PRNGKey(5)
    lat0 = np.array(jax.random.normal(jax.random.split(key)[0], shape,
                                      jnp.float32))
    rng = np.random.default_rng(6)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    video, mask = get_image_to_video_latent(image, None, I2V_FRAMES, (H, W))
    clip = rng.standard_normal((1, CLIP_N, 32)).astype(np.float32)
    lat_j = np.asarray(jpipe(
        jnp.asarray(ins["pos"]), jnp.asarray(ins["neg"]), rng=key,
        video=jnp.asarray(video), mask_video=jnp.asarray(mask),
        clip_encoder_hidden_states=jnp.asarray(clip), clip_apply_ratio=0.4,
        **_kw(ins, jnp.asarray, I2V_FRAMES)))
    seen = []
    forward = type(pipe.transformer).forward

    def spy(self, *args, **kw):
        seen.append((float(kw["clip_encoder_hidden_states"].abs().amax()),
                     kw["clip_attention_mask"].tolist()))
        return forward(self, *args, **kw)

    monkeypatch.setattr(type(pipe.transformer), "forward", spy)

    def port(ratio):
        return pipe(_t(ins["pos"]), _t(ins["neg"]), video=video,
                    mask_video=mask, latents=_t(lat0),
                    clip_encoder_hidden_states=_t(clip),
                    clip_apply_ratio=ratio, **_kw(ins, _t, I2V_FRAMES))

    lat = port(0.4)
    np.testing.assert_allclose(lat.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    ones = [1.0] * 16
    assert [s[0] > 0 for s in seen] == [False, False, True]
    assert seen[2][1] == [[0.0] * 16, ones]  # the unconditional half's mask
    assert seen[0][1] == [[0.0] * 16, [0.0] * 16]
    assert (port(0.0) - lat).abs().max() > 1e-3  # never open
    assert (port(1.0) - lat).abs().max() > 1e-3  # open from step 0


def test_v4_yaml_builds_the_port_module_with_jax_fields():
    """The V4 yaml: the port's HunyuanTransformer3D with JAX's config
    (HunyuanConfig's defaults + basic, time_position_encoding), and the
    slice_mag MagViT with JAX's VAE config."""
    yml = tconfig.load_yaml_config(V4_YAML)
    model, cfg = tconfig.build_transformer(yml, device="meta")
    _, jcfg = jconfig.build_transformer(yml)
    assert isinstance(model, th.HunyuanTransformer3D)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_layers, cfg.inner_dim, cfg.attention_head_dim,
            cfg.time_position_encoding, cfg.effective_out_channels) == (
        40, 1408, 88, True, 8)
    assert next(model.parameters()).device.type == "meta"
    vae, vcfg = tconfig.build_vae(yml, device="meta")
    _, jvcfg = jconfig.build_vae(yml)
    assert {f.name: getattr(vcfg, f.name)
            for f in dataclasses.fields(vcfg)} == {
        f.name: getattr(jvcfg, f.name) for f in dataclasses.fields(vcfg)}
    assert (vcfg.chunk_mode, vcfg.mini_batch_encoder,
            vcfg.mini_batch_decoder) == ("slice_mag", 8, 2)


def test_hybrid_attention_raises_naming_item_11b():
    with pytest.raises(NotImplementedError, match="item 11.b"):
        th.HunyuanConfig(basic_block_type="hybrid_attention")
    with pytest.raises(NotImplementedError, match="item 11.b"):
        tconfig.build_transformer(
            {"transformer_type": "HunyuanTransformer3DModel",
             "basic_block_type": "hybrid_attention"}, device="meta")


def test_trap_resampler_bicubic_is_jax_keys_half(v4):
    """jax.image.resize's bicubic is Keys' a = -0.5 with the out-of-range
    taps dropped and renormalised: the port's table equals JAX's, and
    torch's interpolate (a = -0.75, clamped edges) does not. The bilinear
    resize of k's RoPE tables matches too, odd sizes included."""
    table = _sincos_2d(32, 4, 4).reshape(4, 4, 32)
    want = np.asarray(jax.image.resize(jnp.asarray(table), (5, 5, 32),
                                       "bicubic")).reshape(25, 32)
    _, kv_pos = v4["port"]["basic"].clip_projection.position_tables(25, "cpu")
    np.testing.assert_allclose(kv_pos.numpy(), want, atol=1e-6)
    torch_bicubic = F.interpolate(
        torch.from_numpy(table).permute(2, 0, 1)[None], size=(5, 5),
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).reshape(25, 32)
    assert np.abs(torch_bicubic.numpy() - want).max() > 1e-3
    for size in ((8, 8), (5, 7)):
        x = np.random.default_rng(2).standard_normal((3, *size, 6)).astype(
            np.float32)
        out = (size[0] // 2, size[1] // 2)
        want = jax.image.resize(jnp.asarray(x), (3, *out, 6), "bilinear",
                                antialias=False)
        np.testing.assert_allclose(
            th.resize_2d(_t(x), out, "bilinear").numpy(), np.asarray(want),
            atol=1e-6)


def test_trap_attention_pool_table_is_sized_from_the_t5_length(v4):
    """JAX sizes the pooler's position table from the states it is first
    called on (text_len_t5 + 1 rows in every V4 call); the port from
    text_len_t5, and it raises on another T5 length."""
    jtable = v4["params"]["params"]["time_extra_emb"]["pooler"][
        "positional_embedding"]
    port = v4["port"]["basic"]
    assert jtable.shape == (TEXT_T5 + 1, 24)
    assert port.time_extra_emb.pooler.positional_embedding.shape == (
        TEXT_T5 + 1, 24)
    with pytest.raises(ValueError, match="text_len_t5"):
        port.time_extra_emb(torch.ones(1), torch.zeros(1, TEXT_T5 + 1, 24))


def test_trap_size_and_style_default_to_zeros(v4):
    """image_meta_size and style default to zeros, which the pipelines rely
    on (they pass neither): the default equals explicit zeros, in both
    packages."""
    ins = v4["ins"]
    emb = v4["port"]["basic"].time_extra_emb
    jparams = {"params": v4["params"]["params"]["time_extra_emb"]}
    jemb = jh.HunyuanCombinedEmbedding(JCFG)
    zeros = (np.zeros((2, 6), np.float32), np.zeros(2, np.int32))
    with torch.no_grad():
        got = emb(_t(ins["t"]), _t(ins["t5"]))
        torch.testing.assert_close(
            emb(_t(ins["t"]), _t(ins["t5"]), *map(_t, zeros)), got,
            rtol=0, atol=0)
    default, explicit = jax.jit(lambda p, t, t5, size, style: (
        jemb.apply(p, t, t5, None, None), jemb.apply(p, t, t5, size, style)))(
        jparams, ins["t"], ins["t5"], *zeros)
    np.testing.assert_array_equal(np.asarray(default), np.asarray(explicit))
    np.testing.assert_allclose(got.numpy(), np.asarray(default),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_trap_rope_in_blocks(v4, monkeypatch):
    """Layer 0's attn1 runs without RoPE, every other attn1 with it; the
    cross attentions rotate q only (k of the text is not rotated): attn2
    against JAX's HunyuanAttention on block 1's parameters, also on its
    additive-bias path (plain float32 matmuls; the transformer passes no
    text_bias)."""
    port, ins, rope = v4["port"]["basic"], v4["ins"], v4["rope"]
    calls = []
    forward = th.HunyuanAttention.forward

    def spy(self, x, context=None, rope=None, grid=None, bias=None):
        calls.append((self, rope is None, context is None))
        return forward(self, x, context, rope, grid, bias)

    monkeypatch.setattr(th.HunyuanAttention, "forward", spy)
    with torch.no_grad():
        port(_t(ins["lat"]), _t(ins["t"]), _t(ins["txt"]),
             tuple(_t(r) for r in rope), _t(ins["t5"]))
    monkeypatch.undo()
    no_rope = {(i, name) for i, blk in enumerate(port.blocks)
               for name in ("attn1", "attn2")
               for a, none, _ in calls if a is getattr(blk, name) and none}
    assert no_rope == {(0, "attn1")}
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 48, JCFG.inner_dim)).astype(np.float32)
    ctx = rng.standard_normal((2, 9, 32)).astype(np.float32)
    cos, sin = (np.tile(np.asarray(r), (3, 1)) for r in rope)
    bias = rng.standard_normal((2, 48, 9)).astype(np.float32)
    jattn2 = jh.HunyuanAttention(2, 88, cross_dim=32)
    wants = jax.jit(lambda p, x, c, r, b: [jattn2.apply(
        p, x, context=c, rope=r, grid=(3, 4, 4), bias=bb) for bb in (None, b)])(
        {"params": v4["params"]["params"]["block1"]["attn2"]}, x, ctx,
        (cos, sin), bias)
    for want, b in zip(wants, (None, _t(bias))):
        with torch.no_grad():
            got = port.blocks[1].attn2(_t(x), context=_t(ctx),
                                       rope=(_t(cos), _t(sin)),
                                       grid=(3, 4, 4), bias=b)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


def test_trap_skips_push_before_half_minus_one_and_pop_past_half(v4,
                                                                 monkeypatch):
    """With 4 layers (half 2): block 0's output is pushed, block 3 pops it;
    only block 3 has the skip parameters, in both packages."""
    port, ins, rope = v4["port"]["basic"], v4["ins"], v4["rope"]
    jblocks = v4["params"]["params"]
    assert [("skip_linear" in jblocks[f"block{i}"]) for i in range(4)] == [
        False, False, False, True]
    assert [blk.skip for blk in port.blocks] == [False, False, False, True]
    outs, skips = [], []
    forward = th.HunyuanDiTBlock.forward

    def spy(self, x, *args, skip_states=None, **kw):
        skips.append(skip_states)
        out = forward(self, x, *args, skip_states=skip_states, **kw)
        outs.append(out)
        return out

    monkeypatch.setattr(th.HunyuanDiTBlock, "forward", spy)
    with torch.no_grad():
        port(_t(ins["lat"]), _t(ins["t"]), _t(ins["txt"]),
             tuple(_t(r) for r in rope), _t(ins["t5"]))
    assert [s is None for s in skips] == [True, True, True, False]
    assert skips[3] is outs[0]


def test_trap_two_gelus(v4, monkeypatch):
    """The FFN takes the tanh gelu, the CLIP branch's GEGLU the exact one,
    in both packages (JAX's calls seen as its forward is traced)."""
    port, ins, rope = v4["port"]["basic"], v4["ins"], v4["rope"]
    seen_t, seen_j = [], []
    gelu, jgelu = F.gelu, jh.nn.gelu

    def spy(x, approximate="none"):
        seen_t.append(approximate == "tanh")
        return gelu(x, approximate=approximate)

    def jspy(x, approximate=True):
        seen_j.append(bool(approximate))
        return jgelu(x, approximate=approximate)

    monkeypatch.setattr(F, "gelu", spy)
    monkeypatch.setattr(jh.nn, "gelu", jspy)
    kw = dict(encoder_hidden_states_t5=ins["t5"],
              clip_encoder_hidden_states=ins["clip"])
    model = jh.HunyuanTransformer3D(dataclasses.replace(
        JCFG, basic_block_type="basic"))
    jax.eval_shape(lambda p: model.apply(p, ins["lat"], ins["t"], ins["txt"],
                                         rope, **kw), _basic(v4["params"]))
    with torch.no_grad():
        port(_t(ins["lat"]), _t(ins["t"]), _t(ins["txt"]),
             tuple(_t(r) for r in rope), **{k: _t(v) for k, v in kw.items()})
    assert seen_t == seen_j == [False, True] * 4


def test_trap_two_eps(v4):
    """The Resampler's LayerNorms take eps 1e-5, every other norm
    norm_eps 1e-6: on CLIP states of variance ~1e-6, where the two eps
    values part, the port's Resampler equals JAX's, and a block on
    activations of variance ~1e-8 equals JAX's block."""
    port, params = v4["port"]["basic"], v4["params"]["params"]
    assert port.clip_projection.ln_q.eps == port.clip_projection.ln_kv.eps == 1e-5
    assert port.cfg.norm_eps == 1e-6
    rng = np.random.default_rng(8)
    clip = 1e-3 * rng.standard_normal((2, CLIP_N, 32)).astype(np.float32)
    want = jax.jit(jh.Resampler(4, 32, 2).apply)(
        {"params": params["clip_projection"]}, clip)
    with torch.no_grad():
        got = port.clip_projection(_t(clip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    x = 1e-4 * rng.standard_normal((2, 48, JCFG.inner_dim)).astype(np.float32)
    temb = rng.standard_normal((2, JCFG.inner_dim)).astype(np.float32)
    text = rng.standard_normal((2, TEXT + TEXT_T5, 32)).astype(np.float32)
    cos, sin = v4["rope"]
    want = jax.jit(lambda p, *a: jh.HunyuanDiTBlock(JCFG).apply(
        p, *a, grid=(3, 4, 4)))({"params": params["block1"]}, x, text, temb,
                                (cos, sin))
    with torch.no_grad():
        got = port.blocks[1](_t(x), _t(text), _t(temb), (_t(cos), _t(sin)),
                             grid=(3, 4, 4))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
