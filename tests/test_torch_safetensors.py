"""The port's own safetensors reader and writer
(easyanimate_tpu_torch/utils/safetensors_io.py) against the safetensors
package, the sharded checkpoint writer, and a proof that the port's loading
path imports none of safetensors, transformers, yaml, jax or flax.

No JAX here; the whole file takes a few seconds.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  mmdit_config_json,
                                                  save_reference_checkpoint)
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit, MagvitVAEConfig
from easyanimate_tpu_torch.utils import safetensors_io as io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_convert.py's TINY_VAE
TINY_VAE = MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=2, norm_num_groups=4, mini_batch_encoder=2)


def write_vae_and_scheduler(root, vae_cfg, vae_sd):
    """vae/ (config.json with cache_mag_vae + one safetensors file) and
    scheduler/scheduler_config.json (FlowMatch, shift 3) under `root`."""
    save_reference_checkpoint(os.path.join(root, "vae"), vae_sd, {
        "latent_channels": vae_cfg.latent_channels,
        "block_out_channels": list(vae_cfg.block_out_channels),
        "down_block_types": list(vae_cfg.down_block_types),
        "up_block_types": list(vae_cfg.up_block_types),
        "layers_per_block": vae_cfg.layers_per_block,
        "norm_num_groups": vae_cfg.norm_num_groups,
        "mini_batch_encoder": vae_cfg.mini_batch_encoder,
        "cache_mag_vae": True})
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    with open(os.path.join(root, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "num_train_timesteps": 1000, "shift": 3.0,
                   "use_dynamic_shifting": True}, f)


def write_tiny_model_dir(root, seed=0):
    """A reference-layout model directory written by the port alone: the
    tiny MMDiT (sharded) and TINY_VAE with random float32 weights."""
    gen = torch.Generator().manual_seed(seed)
    cfg = PRESETS["tiny"]
    model = init_random_(EasyAnimateTransformer3D(cfg, device="cpu"), gen)
    vae = init_random_(AutoencoderKLMagvit(TINY_VAE, device="cpu"), gen)
    save_reference_checkpoint(os.path.join(root, "transformer"),
                              model.state_dict(), mmdit_config_json(cfg),
                              max_shard_bytes=40_000)
    write_vae_and_scheduler(root, TINY_VAE, vae.state_dict())
    return model, vae


def _every_dtype(seed=0):
    g = torch.Generator().manual_seed(seed)
    f = lambda *s: torch.randn(*s, generator=g)
    i = lambda lo, hi, *s, dt: torch.randint(lo, hi, s, generator=g, dtype=dt)
    return {
        "bf16": f(3, 5).to(torch.bfloat16), "f16": f(4, 2).half(),
        "f32": f(2, 3, 4), "f64": f(5).double(),
        "i8": i(-100, 100, 7, dt=torch.int8), "u8": i(0, 255, 3, 3, dt=torch.uint8),
        "i16": i(-3000, 3000, 6, dt=torch.int16),
        "i32": i(-10 ** 6, 10 ** 6, 2, 2, dt=torch.int32),
        "i64": i(-10 ** 9, 10 ** 9, 5, dt=torch.int64),
        "bool": f(9) > 0, "f8": f(4, 4).to(torch.float8_e4m3fn),
        "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 3),
    }


def _bits(t):
    """Exact comparison for every dtype (fp8 has no equality on the CPU)."""
    return t.reshape(-1).view(torch.uint8) if t.dtype != torch.bool else t


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a.contiguous()), _bits(b.contiguous()))


def test_round_trip_of_every_dtype(tmp_path):
    ts = _every_dtype()
    path = str(tmp_path / "x.safetensors")
    io.save_file(ts, path, metadata={"format": "pt", "step": 3})
    back = io.load_file(path)
    assert set(back) == set(ts)
    for k, t in ts.items():
        _same(back[k], t)
    assert io.read_metadata(path) == {"format": "pt", "step": "3"}
    # the header is padded with spaces so the data starts 8-byte aligned
    header, start = io.read_header(path)
    assert start % 8 == 0 and "__metadata__" in header


def test_reads_files_the_package_writes(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    safetensors_numpy = pytest.importorskip("safetensors.numpy")
    ts = _every_dtype(1)
    path = str(tmp_path / "pt.safetensors")
    safetensors_torch.save_file(ts, path, metadata={"who": "package"})
    back = io.load_file(path)
    for k, t in ts.items():
        _same(back[k], t)
    assert io.read_metadata(path) == {"who": "package"}
    # numpy has no bf16 / fp8: the numpy writer's file holds the rest
    arrays = {k: t.numpy() for k, t in ts.items()
              if t.dtype not in (torch.bfloat16, torch.float8_e4m3fn)}
    path = str(tmp_path / "np.safetensors")
    safetensors_numpy.save_file(arrays, path)
    back = io.load_file(path)
    assert set(back) == set(arrays)
    for k, a in arrays.items():
        np.testing.assert_array_equal(back[k].numpy(), a)


def test_package_reads_files_the_port_writes(tmp_path):
    safetensors_torch = pytest.importorskip("safetensors.torch")
    ts = _every_dtype(2)
    path = str(tmp_path / "x.safetensors")
    io.save_file(ts, path, metadata={"k": "v"})
    back = safetensors_torch.load_file(path)
    for k, t in ts.items():
        _same(back[k], t)
    from safetensors import safe_open

    with safe_open(path, "pt") as f:
        assert f.metadata() == {"k": "v"}
    # numpy arrays go in as they are (JAX-written checkpoints hold float32)
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    io.save_file(arrays, path)
    np.testing.assert_array_equal(
        safetensors_torch.load_file(path)["w"].numpy(), arrays["w"])


def test_load_file_maps_and_copies_to_a_device(tmp_path):
    path = str(tmp_path / "x.safetensors")
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    io.save_file({"t": t}, path)
    mapped = io.load_file(path)["t"]
    mapped += 1  # copy-on-write: the file is not written
    _same(io.load_file(path)["t"], t)
    on_cpu = io.load_file(path, device="cpu")["t"]
    _same(on_cpu, t)


def test_rejects_bad_files(tmp_path):
    path = str(tmp_path / "x.safetensors")
    io.save_file({"t": torch.zeros(4)}, path)
    header, start = io.read_header(path)
    header["t"]["dtype"] = "U64"
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + bytes(16))
    with pytest.raises(ValueError, match="unsupported dtype"):
        io.load_file(path)
    header["t"].update(dtype="F32", data_offsets=[0, 8])
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw + bytes(16))
    with pytest.raises(ValueError, match="do not hold"):
        io.load_file(path)
    with pytest.raises(FileNotFoundError):
        io.load_dir(str(tmp_path / "nothing"))


def test_sharded_directory_and_its_index(tmp_path):
    g = torch.Generator().manual_seed(3)
    sd = {f"w{i}": torch.randn(16, 16, generator=g).to(torch.bfloat16)
          for i in range(5)}
    sd["b"] = torch.randn(16, generator=g)
    names = save_reference_checkpoint(str(tmp_path / "m"), sd, {"a": 1},
                                      max_shard_bytes=1100)
    assert len(names) == 3 and names[0].endswith("-00001-of-00003.safetensors")
    with open(tmp_path / "m" / "diffusion_pytorch_model.safetensors.index.json") as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(sd)
    assert set(index["weight_map"].values()) == set(names)
    assert index["metadata"]["total_size"] == sum(
        t.numel() * t.element_size() for t in sd.values())
    with open(tmp_path / "m" / "config.json") as f:
        assert json.load(f) == {"a": 1}
    back = io.load_dir(str(tmp_path / "m"))
    assert set(back) == set(sd)
    for k, t in sd.items():
        _same(back[k], t)
        assert k in io.load_file(str(tmp_path / "m" / index["weight_map"][k]))
    # one shard: no index
    assert save_reference_checkpoint(str(tmp_path / "one"), sd) == [
        "diffusion_pytorch_model.safetensors"]
    assert sorted(os.listdir(tmp_path / "one")) == [
        "diffusion_pytorch_model.safetensors"]


def test_loading_path_needs_no_outside_package(tmp_path):
    """In a process where safetensors, transformers, yaml, jax and flax
    cannot be imported, the port reads a file and loads a tiny model
    directory (its own writer's) through load_pipeline on the CPU, then
    denoises one step."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("safetensors", "transformers", "yaml", "jax", "flax",
                     "easyanimate_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import torch
        from easyanimate_tpu_torch.loader import load_pipeline
        from easyanimate_tpu_torch.utils.safetensors_io import load_file
        from tests.test_torch_safetensors import write_tiny_model_dir

        root = {str(tmp_path / "model")!r}
        write_tiny_model_dir(root)
        pipe = load_pipeline(root, dtype="float32", device="cpu")
        assert load_file(root + "/vae/diffusion_pytorch_model.safetensors")
        pos = torch.ones(1, 3, pipe.transformer.cfg.text_embed_dim)
        lat = pipe(pos, None, height=32, width=32, video_length=5,
                   num_inference_steps=1, guidance_scale=1.0,
                   generator=torch.Generator().manual_seed(0),
                   output_type="latent")
        assert torch.isfinite(lat).all()
        bad = [m for m in ("safetensors", "transformers", "yaml", "jax",
                           "flax", "easyanimate_tpu") if sys.modules[m]]
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout[-2000:] + res.stderr[-4000:])
