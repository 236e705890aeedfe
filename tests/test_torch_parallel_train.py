"""The port's data-parallel training (ZeRO-2, FSDP2, dp x sp) against the
JAX package's single-device step, over gloo ranks on the CPU, and the
training driver's --distributed --fsdp run with its checkpoint restored in
one process.

The ranks are spawned once per test (tests/torch_parallel_workers.py).
The global batch and the JAX step's own draws are made once and handed to
both sides; each rank takes its dp rows. Tolerances are JAX's for its
sharded step against its single-device one (tests/test_parallel_training
.py:155-161): the loss within 1e-5 relative, parameters within 1e-5 +
1e-4 relative.
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu_torch import train as ttrain
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)
from easyanimate_tpu_torch.parallel import MeshConfig
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.training.checkpoints import (CheckpointManager,
                                                        flatten_state)
from tests import torch_parallel_workers as workers
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_serving import _random_weights
from tests.test_torch_training import _jax_draws

LOSS_TOL = 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
TRAIN_KW = dict(use_ema=True, learning_rate=1e-3)


@pytest.fixture(scope="module")
def inputs():
    """The tiny MMDiT (XLA attention in JAX), a global batch of 2 and the
    JAX step's draws from its key: (config, inputs for the ranks, the JAX
    step's arguments)."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attn_impl="xla")
    # the port's random weights carried into JAX (a JAX init costs seconds)
    weights = _random_weights(EasyAnimateTransformer3D(
        port_mmdit_cfg(jcfg), device="cpu"), 4)
    rng = np.random.default_rng(5)
    b, f, hh, ww = 2, 2, 8, 8
    lat = rng.standard_normal((b, jcfg.in_channels, f, hh, ww)).astype(np.float32)
    txt = rng.standard_normal((b, 5, jcfg.text_embed_dim)).astype(np.float32)
    crop = get_resize_crop_region_for_grid((hh // 2, ww // 2), 45, 30)
    rope = get_3d_rotary_pos_embed(jcfg.attention_head_dim, crop,
                                   (hh // 2, ww // 2), f)
    tcfg = jtrainer.TrainConfig(**TRAIN_KW)
    key = jax.random.PRNGKey(3)
    batch = {"latents": jnp.asarray(lat), "text": jnp.asarray(txt),
             "rope": tuple(jnp.asarray(r) for r in rope)}
    draws = _jax_draws(key, batch["latents"], tcfg.loss)
    ins = dict(weights=weights, latents=lat, text=txt, rope=rope,
               sigmas=draws.sigmas.numpy(), timesteps=draws.timesteps.numpy(),
               noise=draws.noise.numpy())
    return jcfg, ins, (weights, batch, key)


@pytest.fixture(scope="module")
def jax_step(inputs):
    """JAX's single-device step on the inputs: (state, metrics)."""
    jcfg, _, (weights, batch, key) = inputs
    tcfg = jtrainer.TrainConfig(**TRAIN_KW)
    return jax.jit(jtrainer.make_train_step(JaxModel(jcfg), tcfg))(
        jtrainer.create_train_state(
            jconvert.convert_mmdit_state_dict(weights, jcfg), tcfg),
        batch, key)


@pytest.mark.parametrize("layout,mesh,fsdp", [
    ("zero2", MeshConfig(dp=2, sp=1), False),
    ("fsdp", MeshConfig(dp=2, sp=1), True),
    ("dp2_sp2", MeshConfig(dp=2, sp=2), False),
])
def test_train_step_matches_jax(layout, mesh, fsdp, inputs, request,
                                tmp_path):
    """One AdamW step (clip, EMA) with the batch over dp ranks (and its
    tokens over sp): the loss, the updated float32 masters, the EMA and
    the model's own parameters against JAX's single-device step."""
    jcfg, ins, _ = inputs
    torch.save(ins, tmp_path / "inputs.pt")
    ranks = workers.Ranks(
        workers.train_step, mesh.dp * mesh.sp, tmp_path,
        mmdit_cfg=port_mmdit_cfg(jcfg),
        train_cfg=ttrainer.TrainConfig(**TRAIN_KW), mesh_cfg=mesh, fsdp=fsdp)
    # JAX compiles its step (once per module) while the ranks run
    jstate, jmetrics = request.getfixturevalue("jax_step")
    got = ranks.join()[0]
    assert got["fsdp"] == fsdp
    np.testing.assert_allclose(got["loss"], float(jmetrics["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], float(jmetrics["grad_norm"]),
                               rtol=LOSS_TOL)
    for tree, key in ((jstate.params, "masters"),
                      ({"params": jstate.ema_params}, "ema"),
                      (jstate.params, "model")):
        want = jconvert.export_mmdit_state_dict(tree, jcfg)
        assert set(got[key]) == set(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[key][name], w, atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL,
                                       err_msg=f"{layout} {key} {name}")


def test_driver_fsdp_checkpoint_restores_in_one_process(tmp_path,
                                                        monkeypatch):
    """`train --distributed --fsdp --tiny_demo` on 2 ranks: a step and its
    checkpoint (the first rank writes whole tensors), then a resume on the
    2 ranks (each restoring its chunks, bit for bit) and a second step;
    one process restores that checkpoint bit for bit and the driver
    resumes from it."""
    from PIL import Image

    rng = np.random.RandomState(0)
    entries = []
    for i in range(4):
        Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(
            tmp_path / f"img{i}.png")
        entries.append({"file_path": f"img{i}.png", "text": f"image {i}",
                        "type": "image"})
    (tmp_path / "train.json").write_text(json.dumps(entries))
    base = ["--tiny_demo", "--train_data_meta", str(tmp_path / "train.json"),
            "--train_data_dir", str(tmp_path), "--output_dir",
            str(tmp_path / "out"), "--dataloader_num_workers", "1",
            "--no-sanity_check"]
    ranks = workers.run_ranks(workers.train_driver, 2, tmp_path,
                              argv=base + ["--fsdp"])
    got = ranks[0]
    assert got["fsdp"] and got["resumed_from"] == 1 and got["restored_equal"]
    assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))

    transformer, _ = ttrain._tiny_models(False, device="cpu")
    template = ttrainer.create_train_state(transformer, ttrainer.TrainConfig())
    ckpts = CheckpointManager(str(tmp_path / "out" / "checkpoints"))
    state, cursor, step = ckpts.restore_latest(template)
    assert step == 2 and cursor is not None
    tensors = []
    flatten_state(state, tensors)
    assert len(tensors) == len(got["tensors"])
    for t, w in zip(tensors, got["tensors"]):
        assert torch.equal(t, torch.from_numpy(w))

    # the driver's own resume, one process (TensorBoard's TensorFlow import
    # kept out of the test process)
    if "tensorflow" not in sys.modules:
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    third = ttrain.main(base + ["--max_train_steps", "3",
                                "--resume_from_checkpoint"], device="cpu")
    assert third.step0 == 2 and len(third.losses) == 1
    assert np.isfinite(third.losses[0]) and third.state.step == 3
