"""The port's sequence parallelism (easyanimate_tpu_torch/parallel/) against
the JAX package, over gloo ranks on the CPU.

Each multi-rank test spawns its ranks once (tests/torch_parallel_workers.py:
a FileStore under tmp_path, a 60 s collective timeout, a join deadline);
the ranks run the port on their shards and the test holds the joined
result against JAX on its 8-device CPU mesh (tests/conftest.py). Inputs
are drawn from a seed with numpy and handed to both. Tolerances are JAX's
own for the same checks (tests/test_context_parallel.py): 2e-4 for
outputs, 2e-3 for gradients.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.ops.swa import swa_attention_streams as jax_streams
from easyanimate_tpu.parallel import MeshConfig as JaxMeshConfig
from easyanimate_tpu.parallel import create_mesh as jax_create_mesh
from easyanimate_tpu.parallel import sequence_parallel as jax_sequence_parallel
from easyanimate_tpu.parallel.context import (
    make_sp_attention as jax_make_sp_attention)
from easyanimate_tpu.pipeline.t2v import EasyAnimatePipeline as JaxPipeline
from easyanimate_tpu_torch import train as ttrain
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                       flash_attention_fwd,
                                                       row_dot)
from easyanimate_tpu_torch.parallel import MeshConfig, create_mesh
from easyanimate_tpu_torch.parallel.context import (ring_bwd_hop,
                                                    ring_fwd_hop, ring_merge,
                                                    sequence_parallel)
from easyanimate_tpu_torch.pipeline.t2v import EasyAnimatePipeline
from tests import torch_parallel_workers as workers
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_serving import _random_weights

OUT_TOL = 2e-4
GRAD_TOL = 2e-3


def _jax_mesh(sp):
    return jax_create_mesh(JaxMeshConfig(dp=1, sp=sp, tp=1),
                           devices=jax.devices()[:sp])


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_attention_matches_jax(sp, tmp_path):
    """Ring and all-gather attention over sp token slices: o and the
    gradients of sum(o * g), against JAX's make_sp_attention and jax.grad
    on the same mesh size."""
    rng = np.random.default_rng(sp)
    b, h, s, d = 1, 2, 64, 16
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                  for _ in range(4))
    torch.save(dict(q=q, k=k, v=v, g=g), tmp_path / "inputs.pt")
    ranks = workers.Ranks(workers.sp_attention, sp, tmp_path)

    mesh = _jax_mesh(sp)
    want = {}
    spec = NamedSharding(mesh, P(None, None, "sp", None))
    for mode in ("allgather", "ring"):
        fn = jax_make_sp_attention(mesh, mode=mode, impl="xla", shape=q.shape)
        with mesh:
            args = [jax.device_put(jnp.asarray(x), spec) for x in (q, k, v)]
            want_o = jax.jit(fn)(*args)
            want_g = jax.jit(jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                                      argnums=(0, 1, 2)))(*args)
        want[mode] = want_o, want_g
    ranks = ranks.join()
    for mode, (want_o, want_g) in want.items():
        got = [np.concatenate([r[mode][i] for r in ranks], axis=2)
               for i in range(4)]
        np.testing.assert_allclose(got[0], np.asarray(want_o), atol=OUT_TOL,
                                   rtol=OUT_TOL, err_msg=mode)
        for a, w in zip(got[1:], want_g):
            np.testing.assert_allclose(a, np.asarray(w), atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=mode)


def test_ulysses_swa_streams_match_jax(tmp_path):
    """The SWA streams at sp = 2 (Ulysses): 10 heads, whose direction
    groups (2, 2, 2, 2, 1, 1) straddle the ranks' head slices, and 5
    heads, which sp does not divide (every rank gathers the tokens).
    Outputs against JAX's swa_attention_streams under its
    sequence_parallel scope; gradients of sum(o_t * g_t) + sum(o_v * g_v)
    against jax.grad of it (the text's summed over the ranks);
    head_parallel_call of an attention over the same slices."""
    rng = np.random.default_rng(7)
    grid = dict(num_frames=2, height=4, width=4, cross_attention_size=14)
    st, sv, d = 6, 32, 16
    ins = {}
    for heads in (10, 5):
        one = {f"{x}_{s}": rng.standard_normal((1, heads, n, d)
                                               ).astype(np.float32)
               for x in "qkvg" for s, n in (("txt", st), ("vid", sv))}
        ins[heads] = dict(one, grid=grid)
    torch.save(ins, tmp_path / "inputs.pt")
    ranks = workers.Ranks(workers.ulysses_streams, 2, tmp_path)

    mesh = _jax_mesh(2)
    want = {}
    for heads, one in ins.items():
        args = [jnp.asarray(one[f"{x}_{s}"]) for s in ("txt", "vid")
                for x in "qkv"]

        def loss(*a):
            o_t, o_v = jax_streams(*a, impl="xla", **grid)
            return (jnp.sum(o_t * one["g_txt"]) + jnp.sum(o_v * one["g_vid"]),
                    (o_t, o_v))

        with mesh, jax_sequence_parallel(mesh):
            want[heads] = jax.jit(jax.value_and_grad(
                loss, argnums=tuple(range(6)), has_aux=True))(*args)
    ranks = ranks.join()
    for heads, ((_, (o_t, o_v)), grads) in want.items():
        got = [r[heads] for r in ranks]
        # head_parallel_call (heads over sp, or the gathered fallback) is
        # the same attention as one call
        assert max(r["head_parallel_err"] for r in got) < 1e-5
        for r in got:  # the text stream is every rank's
            np.testing.assert_allclose(r["o_t"], np.asarray(o_t),
                                       atol=OUT_TOL, rtol=OUT_TOL)
        np.testing.assert_allclose(
            np.concatenate([r["o_v"] for r in got], axis=2), np.asarray(o_v),
            atol=OUT_TOL, rtol=OUT_TOL, err_msg=f"{heads} heads")
        for i in range(3):
            np.testing.assert_allclose(
                sum(r["d_txt"][i] for r in got), np.asarray(grads[i]),
                atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"{heads} heads")
            np.testing.assert_allclose(
                np.concatenate([r["d_vid"][i] for r in got], axis=2),
                np.asarray(grads[3 + i]), atol=GRAD_TOL, rtol=GRAD_TOL,
                err_msg=f"{heads} heads")


# the JAX package's tiny MagViT of tests/test_context_parallel.py
JAX_TINY_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2,
    mini_batch_decoder=1, scaling_factor=0.5)


def test_sp_pipeline_matches_jax(tmp_path):
    """The tiny T2V pipeline (one dense, one SWA layer, 6 heads) on 2 sp
    ranks, ring mode, against JAX's pipeline on the same weights at
    JAX's bound (test_context_parallel.py:101); TeaCache under the
    all-gather mode (its carry token-sharded) against the same request on
    one rank without a scope, and its gate's means over token slices
    against the whole tensors'."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=(1,))
    cfg = port_mmdit_cfg(jcfg)
    weights = _random_weights(EasyAnimateTransformer3D(cfg, device="cpu"), 2)
    rng = np.random.default_rng(3)
    kw = dict(height=32, width=32, video_length=5, num_inference_steps=3,
              guidance_scale=6.0)
    # the tiny MagViT's latents: 3 frames of 16 x 16 (192 tokens)
    lat0 = rng.standard_normal((1, 4, 3, 16, 16)).astype(np.float32)
    pos = rng.standard_normal((1, 6, jcfg.text_embed_dim)).astype(np.float32)
    mod, prev = (rng.standard_normal((2, 192, cfg.inner_dim)
                                     ).astype(np.float32) for _ in range(2))
    torch.save(dict(weights=weights, kw=kw, lat0=lat0, pos=pos, mod=mod,
                    prev=prev), tmp_path / "inputs.pt")
    ranks = workers.Ranks(workers.sp_pipeline, 2, tmp_path, mmdit_cfg=cfg,
                          vae_cfg=ttrain.TINY_VAE)

    jpipe = JaxPipeline(transformer=JaxModel(jcfg),
                        vae=jmagvit.AutoencoderKLMagvit(JAX_TINY_VAE),
                        transformer_params=jconvert.convert_mmdit_state_dict(
                            weights, jcfg), vae_params=None)
    want = np.asarray(jpipe(jnp.asarray(pos), jnp.zeros_like(pos),
                            latents=jnp.asarray(lat0), output_type="latent",
                            **kw))
    for r in ranks.join():
        np.testing.assert_allclose(r["ring"], want, atol=OUT_TOL, rtol=OUT_TOL)
        assert r["skips"] == r["skips_one"] == kw["num_inference_steps"] - 2
        np.testing.assert_allclose(r["tea"], r["tea_one"], atol=OUT_TOL,
                                   rtol=OUT_TOL)
        np.testing.assert_allclose(r["rel"], r["rel_one"], rtol=1e-6)


def test_unported_layouts_raise():
    """tp > 1 and dp > 1 inside the serving pipeline raise by name."""
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        create_mesh(MeshConfig(dp=1, sp=1, tp=2))
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ttrain.parse_args(["--train_data_meta", "m.json",
                           "--mesh", "dp=1,sp=1,tp=2"])
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        ttrain.parse_args(["--train_data_meta", "m.json", "--distributed",
                           "--optimizer", "came"])
    with pytest.raises(ValueError, match="--distributed"):
        ttrain.parse_args(["--train_data_meta", "m.json", "--fsdp"])
    # the check reads the scope's mesh shape only: a dp = 2 stand-in
    mesh = types.SimpleNamespace(shape={"dp": 2, "sp": 1, "tp": 1})
    model = EasyAnimateTransformer3D(port_mmdit_cfg(JAX_PRESETS["tiny"]),
                                     device="cpu")
    pipe = EasyAnimatePipeline(model, types.SimpleNamespace(
        cfg=ttrain.TINY_VAE), "cpu")
    with sequence_parallel(mesh), pytest.raises(NotImplementedError,
                                                match="queue 1 item 10"):
        pipe(torch.zeros(1, 4, 24), torch.zeros(1, 4, 24), height=32,
             width=32, video_length=5, num_inference_steps=1,
             output_type="latent")


def test_batch_and_state_layout_helpers():
    """local_batch_size, dp_slice, make_global_batch and data_spec on a
    dp = 2 stand-in mesh (they read its shape and dp rank only), and
    zero_param_specs' rule: each parameter's largest dimension that dp x
    sp divides, or none."""
    from easyanimate_tpu_torch.parallel import (data_spec, dp_slice,
                                                local_batch_size,
                                                make_global_batch,
                                                zero_param_specs)

    mesh = types.SimpleNamespace(shape={"dp": 2, "sp": 2, "tp": 1},
                                 rank=lambda axis: 1)
    assert local_batch_size(6, mesh) == 3 and local_batch_size(5) == 5
    with pytest.raises(ValueError):
        local_batch_size(5, mesh)
    x = torch.arange(12.0).reshape(4, 3)
    assert torch.equal(dp_slice(mesh, x), x[2:])
    batch = make_global_batch(mesh, {"latents": np.ones((1, 4, 2, 8, 8))},
                              {"latents": data_spec("latents")},
                              torch.device("cpu"))
    assert batch["latents"].shape == (1, 4, 2, 8, 8)
    assert data_spec("latents")[0] == "dp" and "sp" not in data_spec("text")
    params = {"w": torch.zeros(12, 6), "b": torch.zeros(6), "n": torch.zeros(3),
              "t": torch.zeros(2, 8, 3)}
    assert zero_param_specs(params, mesh) == {"w": 0, "b": None, "n": None,
                                              "t": 1}


def test_scope_is_seen_from_other_threads():
    """The sequence-parallel scope is process-wide: on the card autograd
    runs the backward (and a remat block's recompute inside it) on a
    thread of its own, which must take the forward's path."""
    import threading

    from easyanimate_tpu_torch.parallel.context import current_sp

    mesh = types.SimpleNamespace(shape={"dp": 1, "sp": 2, "tp": 1})
    seen = []
    with sequence_parallel(mesh, "ring"):
        t = threading.Thread(target=lambda: seen.append(current_sp()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert seen[0] is not None and seen[0].mesh is mesh
    assert seen[0].mode == "ring" and current_sp() is None


def test_ring_hops_match_one_call():
    """The ring's hop bodies in one process (what chip_smoke.py's parallel
    phase runs on the card): K1 per kv shard, then the float32 merge,
    against one call over all keys; the backward hops from the global o and
    lse (one di) against one backward call, dk and dv per shard."""
    gen = torch.Generator().manual_seed(0)
    bh, sq, skv, d, shards = 4, 48, 96, 16, 3
    qf, kf, vf, do = (torch.randn(bh, n, d, generator=gen)
                      for n in (sq, skv, skv, sq))
    o_want, lse_want = flash_attention_fwd(qf, kf, vf)
    o = torch.zeros(bh, sq, d)
    lse = torch.full((bh, sq, 1), -torch.inf)
    for kb, vb in zip(kf.chunk(shards, 1), vf.chunk(shards, 1)):
        o, lse = ring_merge(o, lse, *ring_fwd_hop(qf, kb, vb))
    torch.testing.assert_close(o, o_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, lse_want, atol=1e-5, rtol=1e-5)
    dq_want, dk_want, dv_want = flash_attention_bwd(qf, kf, vf, o_want,
                                                    lse_want, do)
    di = row_dot(o_want, do)
    hops = [ring_bwd_hop(qf, kb, vb, o_want, lse_want, do, di)
            for kb, vb in zip(kf.chunk(shards, 1), vf.chunk(shards, 1))]
    torch.testing.assert_close(sum(h[0] for h in hops), dq_want, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(torch.cat([h[1] for h in hops], 1), dk_want,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(torch.cat([h[2] for h in hops], 1), dv_want,
                               atol=1e-5, rtol=1e-5)
