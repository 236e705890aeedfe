"""Parity of the PyTorch port's MMDiT (embeddings, blocks, the whole tiny
transformer dense and with SWA layers) with the JAX package.

Weights cross as reference-layout numpy dicts: the JAX package exports them
(models/convert.py) and the port loads them with strict=True. Both sides
run in float32 from the same numpy inputs; where the JAX model reaches a
Pallas kernel it runs in interpret mode. Tolerance 5e-4, the JAX
full-model golden test's bound (tests/test_mmdit_full_golden.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models import embeddings as jemb
from easyanimate_tpu.models.blocks import MMDiTBlock as JaxBlock
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu_torch.models import embeddings as temb
from easyanimate_tpu_torch.models.blocks import MMDiTBlock
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  load_reference_state_dict)
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.mmdit import MMDiTConfig
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)

MODEL_TOL = 5e-4


def port_mmdit_cfg(jcfg) -> MMDiTConfig:
    """The port's config with the JAX config's values for its fields."""
    return MMDiTConfig(**{f.name: getattr(jcfg, f.name)
                          for f in dataclasses.fields(MMDiTConfig)})


def export_jax_mmdit(jcfg, seed=0, lat_shape=(1, 4, 2, 8, 8), text_len=5):
    """Init the JAX transformer and export its reference-layout weights.
    Biases and norm affines are perturbed so they are exercised too."""
    model = JaxModel(jcfg)
    lat = jnp.zeros(lat_shape)
    txt = jnp.zeros((1, text_len, jcfg.text_embed_dim))
    variables = model.init(jax.random.PRNGKey(seed), lat, jnp.array([1.0]),
                           txt, None)
    rng = np.random.default_rng(seed)
    variables = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype),
        variables)
    return model, variables, jconvert.export_mmdit_state_dict(variables, jcfg)


def _rope(head_dim, f, gh, gw):
    crop = get_resize_crop_region_for_grid((gh, gw), 45, 30)
    return get_3d_rotary_pos_embed(head_dim, crop, (gh, gw), f)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol)


def test_timestep_embedding_matches_jax():
    t = np.array([0.0, 1.0, 421.5, 999.0], np.float32)
    # at width 3072 the arguments reach ~1000 rad, where one float32 ulp of
    # the argument (6e-5) moves sin/cos by as much
    for dim, tol in ((32, 1e-5), (3072, 1e-4)):
        _close(temb.sinusoidal_timestep_embedding(torch.from_numpy(t), dim),
               jemb.sinusoidal_timestep_embedding(jnp.asarray(t), dim), tol)


def test_patch_embed_and_unpatchify_match_jax(rng):
    b, c, t, h, w, d, p = 2, 4, 3, 8, 6, 12, 2
    x = rng.standard_normal((b, c, t, h, w)).astype(np.float32)
    mod = jemb.PatchEmbed2D(d, p)
    params = mod.init(jax.random.PRNGKey(0), jnp.zeros((b, t, h, w, c)))
    want = mod.apply(params, jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    port = temb.PatchEmbed2D(c, d, p)
    port.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(np.transpose(
            np.asarray(params["params"]["proj"]["kernel"]), (3, 2, 0, 1)))),
        "bias": torch.from_numpy(np.array(params["params"]["proj"]["bias"])),
    })
    _close(port(torch.from_numpy(x)), want, 1e-5)

    tok = rng.standard_normal((b, t * 4 * 3, p * p * c)).astype(np.float32)
    np.testing.assert_array_equal(
        temb.unpatchify(torch.from_numpy(tok), t, 4, 3, p, c).numpy(),
        np.asarray(jemb.unpatchify(jnp.asarray(tok), t, 4, 3, p, c)))


@pytest.mark.parametrize("is_mmdit,after_norm,is_swa", [
    (True, False, False), (False, False, False), (True, True, False),
    (True, False, True), (False, True, True)])
def test_block_matches_jax(rng, is_mmdit, after_norm, is_swa):
    heads, hd, tdim = 6, 16, 32
    dim = heads * hd
    f, gh, gw, st = 2, 4, 4, 5
    sv = f * gh * gw
    jblock = JaxBlock(dim, heads, hd, after_norm=after_norm,
                      is_mmdit=is_mmdit, is_swa=is_swa, norm_eps=1e-5,
                      attn_impl="pallas_interpret")
    vid = rng.standard_normal((2, sv, dim)).astype(np.float32)
    txt = rng.standard_normal((2, st, dim)).astype(np.float32)
    tem = rng.standard_normal((2, tdim)).astype(np.float32)
    cos, sin = _rope(hd, f, gh, gw)
    args = (jnp.asarray(vid), jnp.asarray(txt), jnp.asarray(tem),
            (jnp.asarray(cos), jnp.asarray(sin)), (f, gh, gw))
    params = jblock.init(jax.random.PRNGKey(1), *args)
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    want_v, want_t = jblock.apply(params, *args)

    flat = jconvert._flatten_params(params)
    sd = {src: jconvert._INVERSE[fn](flat[dst])
          for src, (dst, fn) in jconvert._block_mapping("").items()
          if dst in flat}
    block = MMDiTBlock(dim, tdim, heads, hd, after_norm=after_norm,
                       is_mmdit=is_mmdit, is_swa=is_swa, norm_eps=1e-5)
    load_reference_state_dict(block, sd)
    got_v, got_t = block(torch.from_numpy(vid), torch.from_numpy(txt),
                         torch.from_numpy(tem),
                         (torch.from_numpy(cos), torch.from_numpy(sin)),
                         (f, gh, gw))
    _close(got_v, want_v)
    _close(got_t, want_t)


@pytest.mark.parametrize("swa_layers", [None, (1,)])
def test_tiny_transformer_matches_jax(rng, swa_layers):
    """The whole tiny transformer at 6 heads, dense and with an SWA layer."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=swa_layers,
                               attn_impl="pallas_interpret")
    model, variables, sd = export_jax_mmdit(jcfg)
    b, f, hh, ww = 2, 2, 8, 8
    lat = rng.standard_normal((b, jcfg.in_channels, f, hh, ww)).astype(np.float32)
    t = np.array([421.0, 17.0], np.float32)
    txt = rng.standard_normal((b, 5, jcfg.text_embed_dim)).astype(np.float32)
    cos, sin = _rope(jcfg.attention_head_dim, f, hh // 2, ww // 2)
    want = model.apply(variables, jnp.asarray(lat), jnp.asarray(t),
                       jnp.asarray(txt), (jnp.asarray(cos), jnp.asarray(sin)))

    port = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    load_reference_state_dict(port, sd)
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t),
                   torch.from_numpy(txt),
                   (torch.from_numpy(cos), torch.from_numpy(sin)))
    assert got.shape == (b, jcfg.out_channels, f, hh, ww)
    _close(got, want)


def test_load_reference_state_dict_is_strict():
    port = EasyAnimateTransformer3D(PRESETS["tiny"], device="cpu")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    load_reference_state_dict(port, sd)  # exact key set loads
    missing = dict(sd)
    missing.pop("transformer_blocks.1.attn2.to_q.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        load_reference_state_dict(port, missing)
    extra = dict(sd, **{"transformer_blocks.1.bogus": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_reference_state_dict(port, extra)


def test_presets_match_jax_and_12b_parameter_count():
    for name in ("v5.1-12b", "v5.1-12b-inpaint", "v5.1-7b", "tiny"):
        assert PRESETS[name] == port_mmdit_cfg(JAX_PRESETS[name]), name
    model = EasyAnimateTransformer3D(PRESETS["v5.1-12b"], device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert 11.7e9 < n < 11.9e9, n
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


def test_init_random_fills_from_generator():
    cfg = dataclasses.replace(PRESETS["tiny"], num_layers=1)
    a = init_random_(EasyAnimateTransformer3D(cfg, device="cpu"),
                     torch.Generator().manual_seed(3))
    b = init_random_(EasyAnimateTransformer3D(cfg, device="cpu"),
                     torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    blk = a.transformer_blocks[0]
    assert torch.all(blk.norm1.norm.weight == 1)
    assert torch.all(blk.attn1.to_q.bias == 0)
    w = blk.ff.net[2].weight  # fan_in 4 * inner
    assert abs(w.std().item() * w.shape[1] ** 0.5 - 1.0) < 0.1
