"""The port's checkpoints (training/checkpoints.py): training states saved
in safetensors and read back bit for bit, rotation, the fallback past a
checkpoint that does not load, the sampler cursor, and the reference-
format export read back strictly by the port's loader. No JAX: the JAX
package writes its states with orbax, which the port does not read."""
import json
import os
import shutil

import pytest
import torch

from easyanimate_tpu_torch.data import ResumableRandomSampler
from easyanimate_tpu_torch.loader import load_pipeline
from easyanimate_tpu_torch.models.convert import init_random_
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.training import adam8bit, came
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.training.checkpoints import (CheckpointManager,
                                                        flatten_state,
                                                        load_state)
from tests.test_torch_safetensors import write_tiny_model_dir


def _model(seed=0):
    return init_random_(EasyAnimateTransformer3D(PRESETS["tiny"], device="cpu"),
                        torch.Generator().manual_seed(seed))


def _batch(cfg, gen):
    return {"latents": torch.randn(1, 4, 2, 8, 8, generator=gen),
            "text": torch.randn(1, 5, cfg.text_embed_dim, generator=gen)}


def _trained_state(kind):
    """A state after two steps: 'sft' (AdamW, EMA, dual LR), 'came',
    'adamw8bit' (int8 blocks), 'accumulate' (MultiSteps) or 'lora'."""
    model = _model()
    gen = torch.Generator().manual_seed(1)
    kw = {"sft": dict(use_ema=True, trainable_modules=["attn1"],
                      trainable_modules_low_lr=["ff"]),
          "came": dict(optimizer="came"),
          "adamw8bit": dict(optimizer="adamw8bit"),
          "accumulate": dict(gradient_accumulation_steps=2),
          "lora": dict()}[kind]
    tcfg = ttrainer.TrainConfig(learning_rate=1e-3, **kw)
    if kind == "lora":
        init, step = tlora.make_lora_train_step(model, tcfg,
                                                tlora.LoRAConfig(rank=2))
        state = init(gen)
    else:
        state = ttrainer.create_train_state(model, tcfg)
        step = ttrainer.make_train_step(model, tcfg)
    for _ in range(2):
        state, _ = step(state, _batch(model.cfg, gen), generator=gen)
    return state


def _assert_bit_equal(got, want):
    g, w = [], []
    assert flatten_state(got, g) == flatten_state(want, w)  # values too
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.detach(), b.detach())


@pytest.mark.parametrize("kind", ["sft", "came", "adamw8bit", "accumulate",
                                  "lora"])
def test_state_round_trip_is_bit_exact(kind, tmp_path):
    state = _trained_state(kind)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state, {"pos": 3, "epoch": 1, "seed": 42})
    restored, sampler, step = mgr.restore_latest(state)
    assert step == 2 and sampler == {"pos": 3, "epoch": 1, "seed": 42}
    _assert_bit_equal(restored, state)
    if kind == "adamw8bit":
        inner = next(s for s in restored.opt_state
                     if isinstance(s, adam8bit.Adam8bitState))
        assert all(t.dtype == torch.int8 for t in inner.m_q.values())
    if kind == "came":
        inner = next(s for s in restored.opt_state
                     if isinstance(s, came.CAMEState))
        assert all(isinstance(f, came.Factored) for f in inner.v.values())
    # without a template: the structure from state.json, on the given device
    _assert_bit_equal(load_state(str(tmp_path / "ckpt" / "checkpoint-2" / "state"),
                                 device="cpu"), state)


def test_rotation_fallback_and_sampler_cursor(tmp_path):
    state = _trained_state("sft")
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    sampler = ResumableRandomSampler(10, seed=3)
    it = iter(sampler)
    for step in (1, 2, 3):
        next(it)
        mgr.save(step, state, sampler.state_dict())
    assert mgr.steps() == [2, 3]
    assert json.loads((tmp_path / "ckpt" / "checkpoint-3" / "sampler.json")
                      .read_text()) == {"pos": 3, "epoch": 0, "seed": 3}
    # a save cut short: the latest file truncated -> checkpoint-2 loads
    path = tmp_path / "ckpt" / "checkpoint-3" / "state" / "state.safetensors"
    path.write_bytes(path.read_bytes()[:path.stat().st_size // 2])
    restored, cursor, step = mgr.restore_latest(state)
    assert step == 2 and cursor == {"pos": 2, "epoch": 0, "seed": 3}
    _assert_bit_equal(restored, state)
    # a state of another structure does not restore; nothing left -> None
    other = _trained_state("came")
    assert mgr.restore_latest(other) == (None, None, None)
    # re-saving a step replaces it
    mgr.save(2, other)
    assert mgr.restore_latest(other)[2] == 2


def test_resumed_sampler_continues_the_permutation():
    full = ResumableRandomSampler(7, seed=5)
    want = [i for _, i in zip(range(12), full)]  # into the second epoch
    head = ResumableRandomSampler(7, seed=5)
    it = iter(head)
    got = [next(it) for _ in range(4)]
    resumed = ResumableRandomSampler(7, seed=0)
    resumed.load_state_dict(head.state_dict())
    got += [i for _, i in zip(range(8), resumed)]
    assert got == want


def test_reference_format_loads_strictly(tmp_path):
    """save_reference_format's transformer/ and transformer_ema/ replace a
    model directory's transformer and load through load_pipeline
    (strict=True), every tensor equal to the saved one."""
    root = tmp_path / "model"
    write_tiny_model_dir(str(root))
    state = _trained_state("sft")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_reference_format(2, state.params, PRESETS["tiny"],
                              ema_state_dict=state.ema_params)
    for sub, want in (("transformer", state.params),
                      ("transformer_ema", state.ema_params)):
        shutil.rmtree(root / "transformer")
        shutil.copytree(tmp_path / "ckpt" / "checkpoint-2" / sub,
                        root / "transformer")
        pipe = load_pipeline(str(root), dtype="float32", device="cpu",
                             strict=True)
        got = dict(pipe.transformer.named_parameters())
        assert set(got) == set(want)
        for n, t in want.items():
            assert torch.equal(got[n].detach(), t), n
    cfg = json.loads((tmp_path / "ckpt" / "checkpoint-2" / "transformer" /
                      "config.json").read_text())
    assert cfg["num_layers"] == PRESETS["tiny"].num_layers
    assert os.path.exists(tmp_path / "ckpt" / "checkpoint-2" / "transformer_ema"
                          / "diffusion_pytorch_model.safetensors")
