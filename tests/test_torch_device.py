"""The port's entry points build and run on the card unless the caller
names another device: the constructors, the pipelines, build_rope and the
LoRA loaders resolve device=None through easyanimate_tpu_torch.device.
These tests touch no card: the default is read, then pointed at the meta
device to show which entry points follow it."""
import dataclasses

import torch

from easyanimate_tpu_torch import device as tdevice
from easyanimate_tpu_torch.models.convert import (
    export_lora_state_dict, load_reference_lora_state_dict)
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit, MagvitVAEConfig
from easyanimate_tpu_torch.pipeline import (EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline, build_rope)
from easyanimate_tpu_torch.training import lora as tlora

META = torch.device("meta")
TINY_VAE = MagvitVAEConfig(latent_channels=4,
                           block_out_channels=(32, 64, 128, 128),
                           norm_num_groups=8)


def test_default_device_is_the_card():
    assert tdevice.resolve_device() == torch.device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert tdevice.resolve_device(META) == META


def _devices(module):
    return {t.device for t in [*module.parameters(), *module.buffers()]}


def test_entry_points_follow_the_default(monkeypatch, tmp_path):
    monkeypatch.setattr(tdevice, "DEFAULT_DEVICE", "meta")
    model = EasyAnimateTransformer3D(PRESETS["tiny"])
    vae = AutoencoderKLMagvit(TINY_VAE)
    assert _devices(model) == _devices(vae) == {META}
    assert all(t.device == META for t in build_rope(model.cfg, 64, 64, 2))
    for cls in (EasyAnimatePipeline, EasyAnimateInpaintPipeline):
        assert cls(model, vae).device == META

    cpu_model = EasyAnimateTransformer3D(PRESETS["tiny"], device="cpu")
    lora = tlora.lora_init(cpu_model, tlora.LoRAConfig(rank=2),
                           torch.Generator().manual_seed(0))
    loaded, _ = load_reference_lora_state_dict(
        cpu_model, export_lora_state_dict(lora, 2.0))
    tlora.save_lora(str(tmp_path / "l"), lora, tlora.LoRAConfig(rank=2))
    from_file, _ = tlora.load_lora(str(tmp_path / "l"))
    for got in (loaded, from_file):
        assert {t.device for f in got.values() for t in f.values()} == {META}


def test_explicit_meta_device_puts_nothing_on_the_cpu():
    """The 12B inpaint model and the full VAE built on meta: no storage
    anywhere, and the inpaint proj takes 33 channels."""
    model = EasyAnimateTransformer3D(PRESETS["v5.1-12b-inpaint"], device="meta")
    vae = AutoencoderKLMagvit(dataclasses.replace(MagvitVAEConfig(),
                                                  dtype="bfloat16"),
                              device="meta")
    assert _devices(model) == _devices(vae) == {META}
    assert model.proj.weight.shape == (3072, 33, 2, 2)
    assert EasyAnimatePipeline(model, vae).device == META
