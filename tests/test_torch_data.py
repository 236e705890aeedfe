"""The port's training data pipeline (easyanimate_tpu_torch/data) against
the JAX package's: the aspect buckets, the resumable sampler and the
bucket batch sampler, the inpaint masks, the manifest datasets on a tiny
png / mp4 / pose-file manifest, the threaded loader, and the driver's
batch shaping. Both are numpy on the host, so each result is held equal
(float32 pixel arrays exactly; the Plucker rays within 1e-6), with one
loader worker where the draws would otherwise depend on thread timing.

Two traps of the reference the port keeps are pinned here: the sampler
cursor a checkpoint saves runs ahead of training, and the dataset's one
Generator makes an item's draws depend on the order items are loaded.
"""
import importlib.util
import json
import os
import time

import numpy as np
import pytest
import torch

from easyanimate_tpu import data as jdata
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu_torch import data as tdata
from easyanimate_tpu_torch import train as ttrain
from easyanimate_tpu_torch.models.vae import MagvitVAEConfig
from tests.test_torch_train_driver import write_media, write_pose_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bucket_tables_and_closest_ratio_match_jax():
    assert tdata.ASPECT_RATIO_512 == jdata.ASPECT_RATIO_512
    assert len(tdata.ASPECT_RATIO_512) == 40
    for base in (256, 632, 960):
        assert tdata.make_aspect_buckets(base) == jdata.make_aspect_buckets(base)
    for h, w in ((384, 672), (720, 1280), (1000, 250), (512, 512)):
        assert tdata.get_closest_ratio(h, w) == jdata.get_closest_ratio(h, w)


def test_samplers_match_jax_and_resume():
    """The same permutations across epochs; a cursor restored mid-epoch
    continues it; the batch sampler's image / video buckets."""
    t, j = tdata.ResumableRandomSampler(9, seed=4), jdata.ResumableRandomSampler(9, seed=4)
    assert [i for _, i in zip(range(30), t)] == [i for _, i in zip(range(30), j)]
    assert t.state_dict() == j.state_dict()
    head = tdata.ResumableRandomSampler(9, seed=4)
    it = iter(head)
    first = [next(it) for _ in range(5)]
    resumed = tdata.ResumableRandomSampler(9, seed=0)
    resumed.load_state_dict(head.state_dict())
    full = [i for _, i in zip(range(14), tdata.ResumableRandomSampler(9, seed=4))]
    assert first + [i for _, i in zip(range(9), resumed)] == full

    rng = np.random.default_rng(0)
    info = [("image" if rng.random() < 0.4 else "video",
             float(rng.integers(200, 900)), float(rng.integers(200, 900)))
            for _ in range(40)]
    for bs in (1, 3):
        got = tdata.AspectRatioBatchSampler(
            tdata.ResumableRandomSampler(40, seed=1), bs, info)
        want = jdata.AspectRatioBatchSampler(
            jdata.ResumableRandomSampler(40, seed=1), bs, info)
        g = [b for _, b in zip(range(25), got)]
        assert g == [b for _, b in zip(range(25), want)]
        for b in g:  # one kind and one bucket per batch
            assert len({info[i][0] for i in b}) == 1
            assert len({tdata.get_closest_ratio(*info[i][1:])[1] for i in b}) == 1


def test_masks_match_jax():
    """Every archetype, from the same Generator state, frame counts 1-9."""
    kinds = set()
    for seed in range(60):
        for f in (1, 2, 9):
            a = tdata.get_random_mask((f, 1, 12, 20), np.random.default_rng(seed))
            b = jdata.get_random_mask((f, 1, 12, 20), np.random.default_rng(seed))
            np.testing.assert_array_equal(a, b)
            w = np.asarray(tdata.masks._WEIGHTS)
            kinds.add(int(np.random.default_rng(seed).choice(10, p=w / w.sum())))
    assert kinds == set(range(10))
    np.testing.assert_array_equal(
        tdata.get_random_mask((4, 1, 8, 8), np.random.default_rng(0), True),
        jdata.get_random_mask((4, 1, 8, 8), np.random.default_rng(0), True))


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    entries = write_media(str(root), n_images=2, n_videos=2, size=40,
                          frames=20)
    entries.append({"file_path": "vid1.mp4", "text": "declared",
                    "type": "video", "num_frames": 12, "height": 720,
                    "width": 1280})
    write_pose_file(str(root / "camera.txt"), frames=3)
    entries[0]["camera_file_path"] = "camera.txt"
    entries[2]["control_file_path"] = "vid1.mp4"
    entries[2]["camera_file_path"] = "camera.txt"
    (root / "train.json").write_text(json.dumps(entries))
    return root


def _same_item(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            if k == "control_camera_values":
                np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k], w)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("kind", ["plain", "inpaint", "control", "camera"])
def test_dataset_items_match_jax(kind, manifest):
    kw = dict(manifest_path=str(manifest / "train.json"),
              data_root=str(manifest), video_sample_n_frames=5, height=24,
              width=32, seed=3)
    if kind == "inpaint":
        kw["enable_inpaint"] = True
    if kind in ("control", "camera"):
        kw["enable_camera"] = kind == "camera"
        got_ds = tdata.ImageVideoControlDataset(**kw)
        want_ds = jdata.ImageVideoControlDataset(**kw)
    else:
        got_ds, want_ds = tdata.ImageVideoDataset(**kw), jdata.ImageVideoDataset(**kw)
    assert got_ds.sample_info() == want_ds.sample_info()
    for idx in (0, 2, 4, 3, 1, 2):
        _same_item(got_ds[idx], want_ds[idx])
    item = got_ds[2]
    assert item["pixel_values"].shape == (3, 5, 24, 32)
    if kind == "control":
        assert item["control_pixel_values"].shape == (3, 5, 24, 32)
    if kind == "camera":
        assert item["control_camera_values"].shape == (6, 5, 24, 32)
        assert not got_ds[1]["control_camera_values"].any()  # no pose file


def test_resize_center_crop_matches_jax_and_keeps_frames_at_size(rng):
    frames = rng.integers(0, 256, (2, 30, 50, 3), dtype=np.uint8)
    for size in ((24, 32), (40, 20), (30, 50)):
        np.testing.assert_array_equal(tdata.resize_center_crop(frames, *size),
                                      jdata.resize_center_crop(frames, *size))
    assert tdata.resize_center_crop(frames, 30, 50) is frames
    for tok, h, w in ((13104, 384, 672), (1000, 256, 256), (10 ** 6, 512, 512)):
        assert (tdata.video_length_for_resolution(tok, h, w)
                == jdata.video_length_for_resolution(tok, h, w))


def test_loader_batches_and_collate_match_jax(manifest):
    """Ordered, collated batches with one worker: the same arrays and
    texts, batch for batch, through the same bucket sampler."""
    kw = dict(manifest_path=str(manifest / "train.json"),
              data_root=str(manifest), video_sample_n_frames=5, height=24,
              width=32, seed=1, enable_inpaint=True)
    out = []
    for pkg in (tdata, jdata):
        ds = pkg.ImageVideoDataset(**kw)
        bs = pkg.AspectRatioBatchSampler(pkg.ResumableRandomSampler(len(ds), 2),
                                         2, ds.sample_info())
        it = iter(pkg.DataLoader(ds, bs, num_workers=1))
        out.append([next(it) for _ in range(3)])
        it.close()
    for got, want in zip(*out):
        _same_item(got, want)
    assert out[0][0]["pixel_values"].shape[0] == 2
    # device_prefetch: tensors (on the CPU here), in order
    got = list(tdata.device_prefetch(iter(out[0]), size=1, device="cpu"))
    assert [torch.equal(g["pixel_values"], torch.from_numpy(w["pixel_values"]))
            for g, w in zip(got, out[0])] == [True] * 3


def test_loader_raises_what_the_dataset_raises():
    class Broken:
        def __getitem__(self, i):
            raise OSError("unreadable")

    it = iter(tdata.DataLoader(Broken(), [[0]], num_workers=1))
    with pytest.raises(OSError, match="unreadable"):
        next(it)


def _poll(fn, timeout=10.0):
    end = time.monotonic() + timeout
    while not fn() and time.monotonic() < end:
        time.sleep(0.01)


@pytest.mark.parametrize("pkg", [tdata, jdata], ids=["port", "jax"])
def test_trap_saved_cursor_runs_ahead_of_training(pkg):
    """The loader's producer advances the sampler while batches wait in
    its queue (data/prefetch.py:45-66), and the driver saves that cursor
    (examples/train.py:369-376): after one batch is trained the cursor
    has passed the queued ones, so a resume from it skips them."""
    class DS:
        def __getitem__(self, i):
            return {"x": np.full((1,), i, np.float32)}

    sampler = pkg.ResumableRandomSampler(20, seed=0)
    bs = pkg.AspectRatioBatchSampler(sampler, 1, [("image", 512.0, 512.0)] * 20)
    it = iter(pkg.DataLoader(DS(), bs, num_workers=1, prefetch_batches=2))
    trained = int(next(it)["x"][0, 0])
    _poll(lambda: sampler.pos >= 3)
    saved = sampler.state_dict()
    assert saved["pos"] >= 3  # one batch trained, the cursor 3+ ahead
    it.close()
    order = [i for _, i in zip(range(20), pkg.ResumableRandomSampler(20, seed=0))]
    assert trained == order[0]
    resumed = pkg.ResumableRandomSampler(20, seed=0)
    resumed.load_state_dict(saved)
    assert next(iter(resumed)) == order[saved["pos"]] != order[1]


@pytest.mark.parametrize("pkg", [tdata, jdata], ids=["port", "jax"])
def test_trap_one_generator_makes_draws_depend_on_load_order(pkg, manifest):
    """ImageVideoDataset draws clip starts and masks from one Generator
    (data/dataset.py:121-124), which the loader's worker threads share:
    an item's draws depend on what was loaded before it, so with several
    workers they depend on thread timing."""
    kw = dict(manifest_path=str(manifest / "train.json"),
              data_root=str(manifest), video_sample_n_frames=5, height=24,
              width=32, seed=0, enable_inpaint=True)
    a, b = pkg.ImageVideoDataset(**kw), pkg.ImageVideoDataset(**kw)
    first = a[3]["mask"]
    b[2]
    assert not np.array_equal(b[3]["mask"], first)


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "ea_train_example_data", os.path.join(REPO, "examples", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flags", [
    ["--training_with_video_token_length", "--token_sample_size", "64"],
    ["--random_frame_crop"],
    ["--keep_all_node_same_token_length", "--token_sample_size", "512"],
])
def test_shape_batch_matches_jax(flags, rng):
    jax_driver = _jax_driver()
    args = ttrain.build_parser().parse_args(
        ["--train_data_meta", "x", "--video_sample_n_frames", "9"] + flags)
    for trial in range(4):
        loaded = {"pixel_values": rng.random((2, 3, 9, 16, 24), np.float32),
                  "mask": rng.random((2, 1, 9, 16, 24), np.float32),
                  "text": ["a", "b"]}
        copy = {k: (v.copy() if isinstance(v, np.ndarray) else list(v))
                for k, v in loaded.items()}
        got = ttrain._shape_batch(args, loaded, MagvitVAEConfig(),
                                  np.random.RandomState(trial))
        want = jax_driver._shape_batch(args, copy, jmagvit.MagvitVAEConfig(),
                                       np.random.RandomState(trial))
        _same_item(got, want)
