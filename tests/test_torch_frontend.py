"""The port's serving front end: the controller (requests, sampler reset,
LoRA and edition swaps, the 4:2:0 fetch), sliding-window long video, the
HTTP server and its client, and the media helpers.

The cases of tests/test_frontend.py that cover these modules, run against
a tiny port pipeline on the CPU (the tiny MMDiT and the 2-block MagViT of
tests/test_torch_safetensors.py, random float32 weights; a stand-in text
encoder). generate_long_video's window schedule, conditioning frames,
masks and blend are held against JAX's generate_long_video by feeding both
one deterministic numpy stand-in pipeline; color_transfer and
yuv420_to_rgb against JAX's media helpers. Three behaviours deliberately
differ from the JAX controller and server and are pinned here: a
caller's output_type / decode with fetch_yuv420 is a ValueError, the
strings "false" and "0" opt out of "yuv420_fetch" (and turn
"enable_teacache" and "cfg_skip_ratio" off), and generate is annotated
Union[np.ndarray, YUV420Video].
"""
import base64
import dataclasses
import json
import threading
import typing
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.ui import controller as jcontroller
from easyanimate_tpu.utils import media as jmedia
from easyanimate_tpu_torch.api import client
from easyanimate_tpu_torch.api.server import (EasyAnimateAPIServer,
                                              infer_forward, request_kwargs,
                                              video_rgb)
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  save_lora_reference)
from easyanimate_tpu_torch.models.mmdit import (PRESETS,
                                                EasyAnimateTransformer3D)
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.pipeline import (EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline)
from easyanimate_tpu_torch.pipeline.schedulers import (FlowMatchEulerConfig,
                                                       make_scheduler)
from easyanimate_tpu_torch.training.lora import LoRAConfig, lora_init
from easyanimate_tpu_torch.ui import controller as tcontroller
from easyanimate_tpu_torch.ui.controller import (EasyAnimateController,
                                                 generate_long_video)
from easyanimate_tpu_torch.utils import media as tmedia
from easyanimate_tpu_torch.utils.fp8 import fp8_byte_share
from tests.test_torch_safetensors import TINY_VAE, write_tiny_model_dir

PAYLOAD = {"prompt_textbox": "a cat", "length_slider": 5, "width_slider": 32,
           "height_slider": 32, "sample_step_slider": 2,
           "cfg_scale_slider": 2.0, "seed_textbox": 7}


def _pipe(inpaint=True, seed=0):
    cfg = dataclasses.replace(PRESETS["tiny"], in_channels=9 if inpaint else 4)
    gen = torch.Generator().manual_seed(seed)
    model = init_random_(EasyAnimateTransformer3D(cfg, device="cpu"), gen)
    vae = init_random_(AutoencoderKLMagvit(TINY_VAE, device="cpu"), gen)
    cls = EasyAnimateInpaintPipeline if inpaint else EasyAnimatePipeline
    return cls(model, vae, "cpu")


def _encode_text(prompts):
    """A stand-in encoder with the loader's interface."""
    return {"text": torch.full((len(prompts), 6, 24), 0.01)}


@pytest.fixture(scope="module")
def ctl():
    return EasyAnimateController(pipeline=_pipe(), encode_text=_encode_text)


class _FakeController:
    def generate(self, **kw):
        self.last = kw
        t = kw["video_length"]
        return np.zeros((1, 3, t, kw["height"], kw["width"]), np.float32)


def _post(port, route, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


@pytest.fixture
def serve():
    servers = []

    def start(controller):
        srv = EasyAnimateAPIServer(controller)
        srv.serve(port=0, background=True, host="127.0.0.1")
        servers.append(srv)
        return srv.port

    yield start
    for srv in servers:
        srv.shutdown()


def test_infer_forward_protocol():
    """The payload's fields reach generate; a controller without the 4:2:0
    fetch gets no fetch_yuv420; the reply carries a base64 mp4."""
    fake = _FakeController()
    out = infer_forward(fake, dict(PAYLOAD, enable_teacache=True,
                                   cfg_skip_ratio=0.25,
                                   generation_method="Long Video Generation",
                                   partial_video_length=5))
    assert out["message"] == "Success" and len(out["base64_encoding"]) > 0
    assert fake.last == dict(
        prompt="a cat", negative_prompt="", sample_steps=2, width=32,
        height=32, video_length=5, cfg_scale=2.0, seed=7,
        generation_method="Long Video Generation", partial_video_length=5,
        overlap_video_length=4, teacache_threshold=0.1, cfg_skip_ratio=0.25)


@pytest.mark.parametrize("value,engaged", [
    (None, True), (True, True), (1, True), ("true", True), ("yes", True),
    (False, False), (0, False), ("false", False), ("0", False),
    ("False", False)])
def test_yuv420_fetch_default_on_and_opt_out(ctl, value, engaged):
    payload = dict(PAYLOAD) if value is None else dict(PAYLOAD,
                                                       yuv420_fetch=value)
    assert request_kwargs(ctl, payload).get("fetch_yuv420", False) == engaged


@pytest.mark.parametrize("field,value,kwarg", [
    ("enable_teacache", None, None), ("enable_teacache", True, 0.1),
    ("enable_teacache", "true", 0.1), ("enable_teacache", 1, 0.1),
    ("enable_teacache", False, None), ("enable_teacache", 0, None),
    ("enable_teacache", "false", None), ("enable_teacache", "0", None),
    ("enable_teacache", "False", None), ("cfg_skip_ratio", 0.25, 0.25),
    ("cfg_skip_ratio", "0.25", 0.25), ("cfg_skip_ratio", 0, None),
    ("cfg_skip_ratio", "0", None), ("cfg_skip_ratio", "false", None)])
def test_teacache_and_cfg_skip_opt_out(ctl, field, value, kwarg):
    """enable_teacache and cfg_skip_ratio read the strings "false" and "0"
    as off, like yuv420_fetch."""
    payload = dict(PAYLOAD) if value is None else dict(PAYLOAD,
                                                       **{field: value})
    name = ("teacache_threshold" if field == "enable_teacache"
            else "cfg_skip_ratio")
    assert request_kwargs(ctl, payload).get(name) == kwarg


def test_yuv420_fetch_serving_path(ctl):
    """fetch_yuv420 -> decode_latents_yuv420: the planes are the 4:2:0
    re-derivation of the RGB path's video at the same seed (within 1), and
    the server rebuilds RGB from them."""
    kw = dict(prompt="a cat", sample_steps=2, width=32, height=32,
              video_length=5, cfg_scale=2.0, seed=7)
    out = ctl.generate(**kw, fetch_yuv420=True)
    assert isinstance(out, tmedia.YUV420Video)
    assert out.y.shape == (1, 5, 32, 32) and out.y.dtype == np.uint8
    assert out.u.shape == out.v.shape == (1, 5, 16, 16)
    rgb = ctl.generate(**kw)
    r, g, b = (torch.from_numpy(rgb[:, i]).double() for i in range(3))
    want = [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5,
            0.5 * r - 0.418688 * g - 0.081312 * b + 0.5]
    sub = lambda p: 0.25 * (p[..., 0::2, 0::2] + p[..., 1::2, 0::2]
                            + p[..., 0::2, 1::2] + p[..., 1::2, 1::2])
    for plane, w in zip(out, [want[0], sub(want[1]), sub(want[2])]):
        w8 = torch.round(w.clamp(0, 1) * 255.0).numpy()
        assert np.abs(w8 - plane.astype(np.float64)).max() <= 1
    rec = video_rgb(out)
    assert rec.shape == rgb.shape and rec.dtype == np.float32
    np.testing.assert_array_equal(
        rec, tmedia.yuv420_to_rgb(*out).astype(np.float32) / 255.0)


@pytest.mark.parametrize("extra", [dict(output_type="latent"),
                                   dict(decode=False)])
def test_fetch_yuv420_with_output_type_is_a_value_error(ctl, extra):
    """JAX's controller passes output_type / decode twice here (a
    TypeError); the port says which arguments clash."""
    with pytest.raises(ValueError, match="fetch_yuv420"):
        ctl.generate(prompt="x", sample_steps=1, width=32, height=32,
                     video_length=5, fetch_yuv420=True, **extra)
    got = ctl.generate(prompt="x", sample_steps=1, width=32, height=32,
                       video_length=5, **extra)
    assert torch.is_tensor(got) and got.shape == (1, 4, 3, 16, 16)


def test_generate_is_annotated_with_the_yuv_result():
    hints = typing.get_type_hints(EasyAnimateController.generate)
    assert hints["return"] == typing.Union[np.ndarray, tmedia.YUV420Video]


@pytest.mark.parametrize("method", ["Video Generation", "Image Generation",
                                    "Long Video Generation"])
def test_http_request_returns_an_mp4(ctl, serve, method):
    """A request in the JAX protocol through the server comes back
    "Success" with a non-empty base64 mp4."""
    port = serve(ctl)
    payload = dict(PAYLOAD, generation_method=method)
    if method == "Long Video Generation":
        payload.update(length_slider=8, partial_video_length=5,
                       overlap_video_length=2)
    out = _post(port, "/easyanimate/infer_forward", payload)
    assert out["message"] == "Success", out
    mp4 = base64.b64decode(out["base64_encoding"])
    assert len(mp4) > 0 and b"ftyp" in mp4[:64]


def test_client_post_infer_writes_the_mp4(ctl, serve, tmp_path):
    port = serve(ctl)
    path = tmp_path / "out.mp4"
    out = client.post_infer(f"http://127.0.0.1:{port}", prompt="hi",
                            length=5, width=32, height=32, steps=2,
                            save_path=str(path))
    assert out["message"] == "Success"
    assert path.read_bytes() == base64.b64decode(out["base64_encoding"])
    assert path.stat().st_size > 0


def test_index_page_lora_route_and_errors(serve):
    """GET / serves the browser page, POST /update_lora reaches the
    controller, an unknown path is a 404 and a failing request a 500."""

    class Ctl(_FakeController):
        def update_lora(self, path, scale):
            self.lora = (path, scale)

        def update_diffusion_transformer(self, path):
            raise FileNotFoundError(path)

    fake = Ctl()
    port = serve(fake)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30) as r:
        page = r.read().decode()
        assert r.headers["Content-Type"].startswith("text/html")
    for needle in ("infer_forward", "update_diffusion_transformer",
                   "update_edition", "update_lora", "prompt_textbox",
                   "base64_encoding"):
        assert needle in page, needle
    assert _post(port, "/easyanimate/update_lora",
                 {"lora_model_path": "/x.safetensors",
                  "lora_alpha_slider": 0.55})["message"] == "Success"
    assert fake.lora == ("/x.safetensors", 0.55)
    for route, code in (("/nope", 404),
                        ("/easyanimate/update_diffusion_transformer", 500)):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, route, {"diffusion_transformer_path": "/m"})
        assert err.value.code == code


def test_sampler_switch_is_per_request(ctl):
    """A request's sampler does not outlive it: the next request without
    one runs the model's own scheduler. Every sampler name runs; an
    unknown one raises."""
    default = ctl.pipeline.scheduler
    assert isinstance(default, FlowMatchEulerConfig)
    kw = dict(prompt="a cat", sample_steps=1, width=32, height=32,
              video_length=5, cfg_scale=1.0)
    ctl.generate(**kw, sampler="Flow Match")
    assert ctl.pipeline.scheduler == default
    assert ctl.pipeline.scheduler is not default
    ctl.generate(**kw)
    assert ctl.pipeline.scheduler is default
    for name, cls in (("Euler A", "EulerAncestralConfig"),
                      ("DPM++", "DPMSolverConfig"), ("PNDM", "PNDMConfig")):
        out = ctl.generate(**kw, sampler=name)
        assert type(ctl.pipeline.scheduler).__name__ == cls
        assert np.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown sampler"):
        ctl.generate(**kw, sampler="nope")
    ctl.generate(**kw)
    assert ctl.pipeline.scheduler is default
    custom = FlowMatchEulerConfig(shift=2.0, use_dynamic_shifting=False)
    assert make_scheduler("flow", base=custom) == custom
    assert make_scheduler("FLOW", shift=5.0).shift == 5.0


def test_update_lora_with_a_kohya_safetensors(tmp_path):
    """A reference-format LoRA file merged at scale 0.5 changes the result;
    clearing it unmerges at 0.5 and restores it (JAX unmerges at 1)."""
    ctl = EasyAnimateController(pipeline=_pipe(inpaint=False))
    gen = torch.Generator().manual_seed(2)
    lora = lora_init(ctl.pipeline.transformer, LoRAConfig(rank=2), gen)
    for fac in lora.values():
        fac["up"].normal_(0.0, 0.2, generator=gen)
    path = str(tmp_path / "lora_diffusion_pytorch_model.safetensors")
    save_lora_reference(path, lora, alpha=2.0)
    pos = torch.randn(1, 6, 24, generator=gen)
    kw = dict(height=32, width=32, video_length=5, num_inference_steps=2,
              guidance_scale=2.0, output_type="latent")

    def run():
        return ctl.pipeline(pos, torch.zeros_like(pos),
                            generator=torch.Generator().manual_seed(7), **kw)

    base = run()
    ctl.update_lora(path, scale=0.5)
    assert ctl.lora_cfg.rank == 2 and ctl.lora_cfg.alpha == 2.0
    assert (run() - base).abs().max() > 1e-3
    ctl.update_lora(None)
    torch.testing.assert_close(run(), base, rtol=1e-5, atol=1e-5)


def test_a_swap_waits_for_the_running_generation():
    """The server is threaded: a LoRA or checkpoint swap arriving during a
    generation waits for it instead of changing the weights under it."""
    started, release, order = threading.Event(), threading.Event(), []

    def encode(prompts):
        started.set()
        release.wait(30)
        return _encode_text(prompts)

    pipe = _pipe(inpaint=False)

    class Recorded(type(pipe)):
        def __call__(self, *args, **kwargs):
            out = super().__call__(*args, **kwargs)
            # recorded inside the controller's lock: once generate returns,
            # the swap may run before this thread would record anything
            order.append(tuple(out.shape))
            return out

    pipe.__class__ = Recorded
    ctl = EasyAnimateController(pipeline=pipe, encode_text=encode)
    gen = threading.Thread(target=lambda: ctl.generate(
        prompt="x", sample_steps=1, width=16, height=16, video_length=5,
        cfg_scale=1.0))
    swap = threading.Thread(target=lambda: order.append(ctl.update_lora(None)))
    gen.start()
    assert started.wait(30)
    swap.start()
    swap.join(0.5)
    assert swap.is_alive() and not order  # blocked behind the generation
    release.set()
    gen.join(60)
    swap.join(60)
    assert not gen.is_alive() and not swap.is_alive()
    assert order == [(1, 3, 5, 16, 16), None]


def test_update_edition_switches_config(ctl):
    cfg = ctl.update_edition("EasyAnimateV5.1")
    assert ctl.edition == "v5.1" and isinstance(cfg, dict) and cfg
    cfg4 = ctl.update_edition("v4")
    assert ctl.edition == "v4" and cfg4 != cfg
    with pytest.raises(ValueError):
        ctl.update_edition("v99")


def test_update_diffusion_transformer_keeps_fp8_and_the_device(tmp_path):
    root = str(tmp_path / "EasyAnimateV5.1-12b-zh")
    write_tiny_model_dir(root)
    from easyanimate_tpu_torch.loader import load_pipeline

    ctl = EasyAnimateController(pipeline=load_pipeline(
        root, dtype="float32", fp8_weights=True, device="cpu"))
    share = fp8_byte_share(ctl.pipeline.transformer)
    assert share > 0.5
    old = ctl.pipeline
    ctl.update_diffusion_transformer(root)
    assert ctl.pipeline is not old
    assert fp8_byte_share(ctl.pipeline.transformer) == share
    assert ctl.pipeline.device == torch.device("cpu")
    assert isinstance(ctl.pipeline, EasyAnimatePipeline)
    assert ctl.pipeline.teacache_coefficients is not None


def test_media_helpers_match_jax(tmp_path):
    """color_transfer and yuv420_to_rgb equal JAX's; save_videos_grid
    writes a gif and an mp4, with and without the color transfer."""
    rng = np.random.RandomState(0)
    ref = rng.randint(0, 255, (16, 16, 3), np.uint8)
    src = np.clip(ref.astype(np.int32) + 60, 0, 255).astype(np.uint8)
    out = tmedia.color_transfer(src, ref)
    np.testing.assert_array_equal(out, jmedia.color_transfer(src, ref))
    assert abs(out.astype(float).mean() - ref.astype(float).mean()) < 6.0
    y = rng.randint(0, 256, (1, 3, 8, 8), np.uint8)
    u, v = (rng.randint(0, 256, (1, 3, 4, 4), np.uint8) for _ in range(2))
    np.testing.assert_array_equal(tmedia.yuv420_to_rgb(y, u, v),
                                  jmedia.yuv420_to_rgb(y, u, v))
    video = rng.rand(1, 3, 4, 16, 16).astype(np.float32)
    for name, ct in (("v.gif", False), ("v.mp4", False), ("c.mp4", True)):
        tmedia.save_videos_grid(video, str(tmp_path / name),
                                color_transfer_post_process=ct)
        assert (tmp_path / name).stat().st_size > 0
    out = infer_forward(_FakeController(),
                        dict(PAYLOAD, color_transfer_post_process=True))
    assert out["message"] == "Success" and out["base64_encoding"]


# -- sliding-window long video --------------------------------------------


def _stand_in(video, mask, length):
    """A deterministic pipeline result from its inputs alone: keeps the
    conditioned frames, fills the others from the frame index and the
    video's mean."""
    t = np.arange(length, dtype=np.float32).reshape(1, 1, length, 1, 1)
    c = np.arange(3, dtype=np.float32).reshape(1, 3, 1, 1, 1)
    fill = 0.3 + 0.2 * np.sin(0.7 * t + c) + 0.3 * video.mean(
        axis=(2, 3, 4), keepdims=True)
    return (video * (1 - mask) + mask * fill).astype(np.float32)


class _JaxStandIn:
    def __init__(self):
        self.calls = []

    def __call__(self, pos, neg, *, video, mask_video, video_length, **kw):
        video, mask = np.asarray(video), np.asarray(mask_video)
        self.calls.append((video, mask))
        return jnp.asarray(_stand_in(video, mask, video_length))


class _PortStandIn:
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def __call__(self, pos, neg, *, video, mask_video, video_length,
                 output_type, **kw):
        assert output_type == "device"
        video, mask = video.numpy(), mask_video.numpy()
        self.calls.append((video, mask))
        return torch.from_numpy(_stand_in(video, mask, video_length))


@pytest.mark.parametrize("total,partial,overlap,start,end", [
    (90, 49, 4, False, False), (8, 5, 2, False, True), (11, 5, 2, True, True),
    (13, 5, 0, True, False), (20, 9, 4, True, True), (4, 9, 2, True, True)])
def test_generate_long_video_matches_jax(total, partial, overlap, start, end):
    """The window schedule, each window's conditioning frames and mask, and
    the blended output equal JAX's on the same stand-in pipeline (a leftover
    under 4 frames adds no window: 13 frames in windows of 5 give 10)."""
    rng = np.random.default_rng(4)
    img = lambda on: rng.random((3, 8, 8)).astype(np.float32) if on else None
    kw = dict(total_length=total, partial_video_length=partial,
              overlap_video_length=overlap, height=8, width=8,
              start_image=img(start), end_image=img(end),
              num_inference_steps=2, guidance_scale=2.0)
    jpipe, tpipe = _JaxStandIn(), _PortStandIn()
    want = jcontroller.generate_long_video(jpipe, None, None, **kw)
    got = generate_long_video(tpipe, None, None, **kw)
    assert got.shape == want.shape
    assert got.shape[2] == (10 if total == 13 else total)
    assert len(tpipe.calls) == len(jpipe.calls)
    for (gv, gm), (wv, wm) in zip(tpipe.calls, jpipe.calls):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gv, wv)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_long_video_validation_and_v2v_refusal(ctl):
    """Overlaps that would loop forever or break the blend raise (they can
    come from HTTP fields); V2V with Long Video Generation is refused, as is
    a T2V pipeline."""
    pos = torch.zeros(1, 6, 24)
    for bad in (5, 6, -1, 3):
        with pytest.raises(ValueError, match="overlap"):
            generate_long_video(_PortStandIn(), pos, pos, total_length=20,
                                partial_video_length=5,
                                overlap_video_length=bad, height=8, width=8)
    with pytest.raises(ValueError, match="total_length"):
        generate_long_video(_PortStandIn(), pos, pos, total_length=0)
    kw = dict(prompt="x", video_length=8, width=16, height=16,
              sample_steps=1, cfg_scale=2.0,
              generation_method="Long Video Generation")
    with pytest.raises(ValueError, match="Long Video"):
        ctl.generate(**kw, source_video=np.zeros((1, 3, 5, 16, 16),
                                                 np.float32))
    t2v = EasyAnimateController(pipeline=_pipe(inpaint=False),
                                encode_text=_encode_text)
    with pytest.raises(ValueError, match="inpaint pipeline"):
        t2v.generate(**kw)


def test_long_video_through_the_controller(ctl):
    """Zero overlap abuts the windows; an end image conditions the final
    window; the start image only the first; the result is the (1, 3,
    total, H, W) float video."""
    start = np.full((16, 16, 3), 0.7, np.float32)
    end = np.full((16, 16, 3), 0.2, np.float32)
    kw = dict(prompt="x", width=16, height=16, sample_steps=1, cfg_scale=2.0,
              generation_method="Long Video Generation",
              partial_video_length=5)
    for overlap, total in ((0, 10), (2, 8)):
        out = ctl.generate(**kw, video_length=total, start_image=start,
                           overlap_video_length=overlap, end_image=end)
        assert out.shape == (1, 3, total, 16, 16) and np.isfinite(out).all()


def test_long_video_start_image_conditions_the_first_window_only():
    pipe = _PortStandIn()
    generate_long_video(pipe, None, None, total_length=13,
                        partial_video_length=5, overlap_video_length=0,
                        height=8, width=8,
                        start_image=np.full((3, 8, 8), 0.7, np.float32))
    masks = [m for _, m in pipe.calls]
    assert len(masks) >= 2
    assert masks[0][0, 0, 0].min() == 0.0
    assert all(m.min() == 1.0 for m in masks[1:])


def test_long_video_dispatches_the_next_window_before_fetching(monkeypatch):
    """Each window's host copy is waited for only after the next window is
    queued, so the fetch and the blend run beside that denoise."""
    events = []

    class Copy:
        def __init__(self, tensor):
            self.tag = f"chunk{len(pipe.calls)}"
            self.tensor = tensor

        def result(self):
            events.append(("fetch", self.tag))
            return self.tensor.numpy()

    class Pipe(_PortStandIn):
        def __call__(self, *a, **kw):
            events.append(("dispatch", f"chunk{len(self.calls) + 1}"))
            return super().__call__(*a, **kw)

    pipe = Pipe()
    monkeypatch.setattr(tcontroller, "HostCopy", Copy)
    out = generate_long_video(pipe, None, None, total_length=11,
                              partial_video_length=5, overlap_video_length=2,
                              height=8, width=8)
    assert out.shape == (1, 3, 11, 8, 8)
    n = len(pipe.calls)
    assert n >= 3
    for i in range(1, n):
        assert (events.index(("dispatch", f"chunk{i + 1}"))
                < events.index(("fetch", f"chunk{i}"))), events
