"""The port's reward models (easyanimate_tpu_torch.reward) against the JAX
package: the CLIP towers against a tiny random transformers
FlaxCLIPModel (text and image features, per-token outputs) at quick_gelu
and gelu; CLIPScoreReward, AestheticReward and MPSReward, with their
gradients with respect to the frames; the converters; the traps of the
JAX scorers, one test each.

Weights: the CLIP towers come from the Flax model through
clip_state_dict_from_flax; the MPS cross model and the aesthetic head go
the other way, from the port's random weights through the JAX package's
own converters of the reference layouts. JAX's MPSReward calls
`model.text_model(...)` / `model.vision_model(...)`, which FlaxCLIPModel
does not expose, so it gets a thin adapter over the same Flax module.
Tolerances: 1e-5 (rtol and atol) for CLIP features, float32 sums in
another order; 1e-4 of the largest value for scores and their gradients,
which pass through the whole tower and its backward.
"""
import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.reward import mps as jmps
from easyanimate_tpu.reward import reward_fn as jrf
from easyanimate_tpu_torch.models.convert import init_random_
from easyanimate_tpu_torch.reward import clip as tclip
from easyanimate_tpu_torch.reward import mps as tmps
from easyanimate_tpu_torch.reward import reward_fn as trf
from easyanimate_tpu_torch.utils.safetensors_io import save_file

transformers = pytest.importorskip("transformers")

FEAT_TOL = 1e-5
SCORE_TOL = 1e-4
VOCAB, TEXT_LEN = 1000, 77


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, scale=None):
    want = np.asarray(want)
    atol = tol if scale is None else tol * scale
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=atol)


def _rel(got, want, tol):
    want = np.asarray(want)
    _close(got, want, tol, scale=float(np.abs(want).max()))


class WordTokenizer:
    """A stand-in CLIP tokenizer (the Hugging Face call interface): bos,
    each word hashed into the vocabulary, eos, zero padding."""

    model_max_length = TEXT_LEN

    def __init__(self, eos=VOCAB - 1):
        self.eos = eos

    def __call__(self, prompts, padding, truncation, max_length,
                 return_tensors):
        ids = np.zeros((len(prompts), max_length), np.int32)
        mask = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            words = [VOCAB - 2] + [1 + sum(map(ord, w)) * 7919 % (VOCAB - 4)
                                   for w in p.split()]
            row = (words[:max_length - 1] + [self.eos])
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _flax_clip(act="quick_gelu", eos=2, projection_dim=16, seed=0):
    from transformers import CLIPConfig, FlaxCLIPModel

    cfg = CLIPConfig(
        text_config=dict(hidden_size=32, intermediate_size=64,
                         num_hidden_layers=2, num_attention_heads=2,
                         vocab_size=VOCAB, max_position_embeddings=TEXT_LEN,
                         hidden_act=act, eos_token_id=eos),
        vision_config=dict(hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           image_size=32, patch_size=8, hidden_act=act),
        projection_dim=projection_dim)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = FlaxCLIPModel(cfg, seed=seed)
    # perturb the norms, biases and logit_scale so they are exercised
    rng = np.random.default_rng(seed)
    model.params = jax.tree.map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(a.dtype),
        model.params)
    return model


def _port_clip(flax_model):
    cfg = tclip.CLIPConfig.from_dict(flax_model.config.to_dict())
    port = tclip.CLIPModel(cfg, device="cpu")
    port.load_state_dict(tclip.clip_state_dict_from_flax(flax_model.params),
                         strict=True)
    return port


class FlaxCLIPAdapter:
    """The interface JAX's MPSReward calls: params, config, text_model and
    vision_model, over the FlaxCLIPModel's own module."""

    def __init__(self, model):
        self.model, self.params, self.config = model, model.params, model.config

    def text_model(self, input_ids, attention_mask):
        pos = jnp.broadcast_to(jnp.arange(input_ids.shape[-1]),
                               input_ids.shape)
        return self.model.module.apply(
            {"params": self.params}, jnp.asarray(input_ids),
            jnp.asarray(attention_mask), pos,
            method=lambda m, i, a, p: m.text_model(
                input_ids=i, attention_mask=a, position_ids=p,
                deterministic=True))

    def vision_model(self, pixel_values):
        return self.model.module.apply(
            {"params": self.params}, jnp.transpose(pixel_values, (0, 2, 3, 1)),
            method=lambda m, x: m.vision_model(pixel_values=x,
                                               deterministic=True))


@pytest.fixture(scope="module")
def clip_pair():
    model = _flax_clip()
    return model, _port_clip(model)


def _frames(rng, shape=(1, 4, 24, 40, 3)):
    return rng.random(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# CLIP towers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,eos", [("quick_gelu", 2), ("gelu", VOCAB - 1)])
def test_clip_features_match_flax(rng, act, eos):
    """get_text_features, get_image_features and both towers' per-token
    outputs; eos 2 pools the largest id (the pre-fix configs), any other
    the first eos_token_id."""
    model = _flax_clip(act, eos)
    port = _port_clip(model)
    tok = WordTokenizer(eos=VOCAB - 1)
    ids = tok(["a cat on a mat", "one", "the quick brown fox jumps"],
              "max_length", True, TEXT_LEN, "np")
    pix = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    t_ids, t_mask = (torch.from_numpy(ids[k]).long()
                     for k in ("input_ids", "attention_mask"))
    with torch.no_grad():
        _close(port.get_text_features(t_ids, t_mask),
               model.get_text_features(ids["input_ids"],
                                       ids["attention_mask"]), FEAT_TOL)
        _close(port.get_image_features(torch.from_numpy(pix)),
               model.get_image_features(pix), FEAT_TOL)
        adapter = FlaxCLIPAdapter(model)
        _close(port.text_model(t_ids, t_mask)[0],
               adapter.text_model(ids["input_ids"],
                                  ids["attention_mask"]).last_hidden_state,
               FEAT_TOL)
        _close(port.vision_model(torch.from_numpy(pix))[0],
               adapter.vision_model(jnp.asarray(pix)).last_hidden_state,
               FEAT_TOL)


def test_clip_loads_a_hugging_face_directory(tmp_path, clip_pair):
    """The port's parameter names are Hugging Face's torch CLIPModel's;
    from_pretrained reads config.json + safetensors strictly, dropping an
    older checkpoint's position_ids buffers."""
    from transformers import CLIPModel as HFCLIPModel

    flax_model, port = clip_pair
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hf = HFCLIPModel(flax_model.config)
    assert set(hf.state_dict()) == set(port.state_dict())
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    sd["text_model.embeddings.position_ids"] = np.arange(TEXT_LEN)[None]
    save_file(sd, str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(
        json.dumps(flax_model.config.to_dict()))
    loaded = tclip.CLIPModel.from_pretrained(str(tmp_path), device="cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert loaded.cfg == port.cfg


def test_clip_presets_are_the_published_widths():
    h, l = tclip.CLIP_PRESETS["clip-vit-h-14"], tclip.CLIP_PRESETS["clip-vit-l-14"]
    assert (h.vision_config.num_hidden_layers, h.vision_config.hidden_size,
            h.vision_config.patch_size, h.vision_config.image_size) == (
                32, 1280, 14, 224)
    assert (h.text_config.num_hidden_layers, h.text_config.hidden_size,
            h.projection_dim, h.text_config.hidden_act) == (24, 1024, 1024,
                                                             "gelu")
    assert (l.vision_config.num_hidden_layers, l.vision_config.hidden_size,
            l.projection_dim, l.vision_config.hidden_act) == (24, 1024, 768,
                                                              "quick_gelu")
    n = sum(p.numel() for p in tclip.CLIPModel(h, device="meta").parameters())
    assert 0.95e9 < n < 1.0e9  # CLIP-H/14: 986M parameters


# ---------------------------------------------------------------------------
# scorers and their gradients
# ---------------------------------------------------------------------------


def _port_grad(scorer, frames, *args):
    fr = torch.from_numpy(frames).requires_grad_(True)
    loss, reward = scorer(fr, *args)
    loss.backward()
    return loss, reward, fr.grad


def _jax_grad(scorer, frames, *args):
    (loss, reward), g = jax.jit(jax.value_and_grad(
        lambda fr: scorer(fr, *args), has_aux=True))(jnp.asarray(frames))
    return loss, reward, g


def test_clip_score_reward_matches_jax(rng, clip_pair):
    flax_model, port = clip_pair
    tok = WordTokenizer()
    frames = _frames(rng)
    prompts = ["a cat"]
    want = _jax_grad(jrf.CLIPScoreReward(flax_model, tok, num_frames=3),
                     frames, prompts)
    for cls in (trf.CLIPScoreReward, trf.HPSReward, trf.PickScoreReward):
        got = _port_grad(cls(port, tok, num_frames=3), frames, prompts)
        for g, w in zip(got, want):
            _rel(g, w, SCORE_TOL)
    assert float(np.abs(_np(got[2])).max()) > 0  # grads reach the frames


def test_aesthetic_reward_matches_jax(rng, clip_pair):
    """The head from a reference state dict (layers.0/2/4 of the
    improved-aesthetic-predictor) through both packages' converters."""
    flax_model, port = clip_pair
    gen = torch.Generator().manual_seed(3)
    sd = {"layers.0.weight": torch.randn(24, 16, generator=gen),
          "layers.0.bias": torch.randn(24, generator=gen),
          "layers.2.weight": torch.randn(8, 24, generator=gen),
          "layers.2.bias": torch.randn(8, generator=gen),
          "layers.4.weight": torch.randn(1, 8, generator=gen),
          "layers.4.bias": torch.randn(1, generator=gen)}
    jhead = jrf.convert_aesthetic_head({k: v.numpy() for k, v in sd.items()})
    thead = trf.convert_aesthetic_head(sd)
    assert trf.convert_aesthetic_head(jhead).keys() == thead.keys()
    frames = _frames(rng, (2, 5, 20, 20, 3))
    want = _jax_grad(jrf.AestheticReward(flax_model, jhead, num_frames=2),
                     frames)
    got = _port_grad(trf.AestheticReward(port, thead, num_frames=2), frames)
    for g, w in zip(got, want):
        _rel(g, w, SCORE_TOL)


@pytest.fixture(scope="module")
def mps_pair():
    """A tiny CLIP projecting to MPS's width (JAX's MPSReward builds the
    cross model at dim 1024) and the cross model, random on the port's
    side, through JAX's converter of the reference state dict."""
    flax_model = _flax_clip("gelu", 2, projection_dim=1024, seed=1)
    cross = init_random_(tmps.MPSCrossModel(device="cpu"),
                         torch.Generator().manual_seed(4))
    with torch.no_grad():
        for n, p in cross.named_parameters():
            if n.endswith("gamma"):
                p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator(
                    ).manual_seed(len(n))))
    ref_sd = {f"cross_model.{k}": v.numpy()
              for k, v in cross.state_dict().items()}
    jparams = jmps.convert_mps_cross_state_dict(ref_sd)
    return flax_model, _port_clip(flax_model), cross, jparams, ref_sd


def test_mps_reward_matches_jax(rng, mps_pair):
    flax_model, port, cross, jparams, _ = mps_pair
    tok = WordTokenizer()
    frames = _frames(rng, (1, 3, 24, 24, 3))
    prompts = ["a red bird on a branch"]
    def jax_loss(fr, cross_params, clip_params):
        # every weight an argument: closed over, XLA folds them as constants
        adapter = FlaxCLIPAdapter(flax_model)
        adapter.params = clip_params
        return jmps.MPSReward(adapter, tok, cross_params, num_frames=2)(
            fr, prompts)

    (loss, reward), g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(frames), jparams, flax_model.params)
    want = (loss, reward, g)
    got = _port_grad(tmps.MPSReward(port, tok, cross, num_frames=2), frames,
                     prompts)
    for g, w in zip(got, want):
        _rel(g, w, SCORE_TOL)


def test_mps_converters(mps_pair, rng):
    """Reference state dict -> port (strict); the JAX tree -> port equals
    it; the cross model alone equals JAX's on the same tokens."""
    _, _, cross, jparams, ref_sd = mps_pair
    sd = tmps.convert_mps_cross_state_dict(ref_sd)
    from_flax = tmps.mps_cross_state_dict_from_flax(jparams)
    assert set(sd) == set(from_flax) == set(cross.state_dict())
    for k, v in cross.state_dict().items():
        assert torch.equal(sd[k], v) and torch.equal(from_flax[k], v), k
    img = rng.standard_normal((2, 9, 1024)).astype(np.float32)
    txt = rng.standard_normal((2, 7, 1024)).astype(np.float32)
    mask = np.zeros((2, 9, 7), np.float32)
    mask[1, :, 3:] = -np.inf
    want = jax.jit(jmps.MPSCrossModel().apply)(
        jparams, *map(jnp.asarray, (img, txt, mask)))
    with torch.no_grad():
        got = cross(*map(torch.from_numpy, (img, txt, mask)))
    _rel(got, want, SCORE_TOL)


# ---------------------------------------------------------------------------
# the traps, one test each
# ---------------------------------------------------------------------------


def test_trap_frames_resize_to_a_square_bilinear_without_antialias(rng):
    frames = _frames(rng, (2, 3, 24, 40, 3))  # non-square, downsampled
    want = jrf._preprocess(jnp.asarray(frames), 16)
    got = trf._preprocess(torch.from_numpy(frames), 16)
    assert got.shape == (6, 3, 16, 16)
    _close(got, want, FEAT_TOL)
    up = _frames(rng, (1, 1, 8, 12, 3))  # and upsampled
    _close(trf._preprocess(torch.from_numpy(up), 32),
           jrf._preprocess(jnp.asarray(up), 32), FEAT_TOL)


@pytest.mark.parametrize("t,num", [(1, 4), (5, 4), (17, 4), (49, 4), (13, 5),
                                   (49, 7), (100, 3)])
def test_trap_subsample_indices_are_truncated_linspace(t, num):
    frames = np.arange(t, dtype=np.float32).reshape(1, t, 1, 1, 1)
    want = np.asarray(jrf._subsample(jnp.asarray(frames), num)).ravel()
    got = _np(trf._subsample(torch.from_numpy(frames), num)).ravel()
    np.testing.assert_array_equal(got, want)


def test_trap_logit_scale_is_exponentiated(rng, clip_pair):
    flax_model, port = clip_pair
    tok = WordTokenizer()
    frames = _frames(rng, (1, 1, 32, 32, 3))
    scorer = trf.CLIPScoreReward(port, tok, num_frames=1)
    _, reward = scorer(torch.from_numpy(frames), ["a dog"])
    with torch.no_grad():
        img = port.get_image_features(trf._preprocess(
            torch.from_numpy(frames), 32))
        ids, mask = tclip.tokenize(tok, ["a dog"])
        txt = port.get_text_features(ids, mask)
    cos = torch.nn.functional.cosine_similarity(img, txt)[0]
    scale = float(port.logit_scale)
    assert abs(scale) > 0.5  # exp(s) and s are far apart
    _close(reward, cos * np.exp(scale), FEAT_TOL)


def test_trap_every_prompt_is_scored_and_averaged(rng, clip_pair):
    """The driver scores against every line of --prompt_path: with one
    decoded frame the image feature broadcasts over the N prompts and the
    reward is their mean."""
    flax_model, port = clip_pair
    tok = WordTokenizer()
    frames = _frames(rng, (1, 1, 16, 16, 3))
    prompts = ["a cat", "a dog on a hill", "rain"]
    scorer = trf.CLIPScoreReward(port, tok)
    _, all_reward = scorer(torch.from_numpy(frames), prompts)
    each = [float(scorer(torch.from_numpy(frames), [p])[1]) for p in prompts]
    _close(all_reward, np.mean(each), FEAT_TOL)
    _, want = jrf.CLIPScoreReward(flax_model, tok)(jnp.asarray(frames),
                                                   prompts)
    _rel(all_reward, want, SCORE_TOL)


def test_trap_aesthetic_head_has_relu_between_layers(rng):
    """A head whose first layer's outputs are all negative: the ReLU zeroes
    them, so the score is the last bias; without it, it would not be."""
    head = {"w0": -torch.ones(4, 3), "b0": -torch.ones(3),
            "w1": torch.ones(3, 1), "b1": torch.full((1,), 0.25)}

    class Unit(torch.nn.Module):  # image features = the pooled pixels
        cfg = tclip.CLIPConfig(vision_config=tclip.CLIPVisionConfig(
            image_size=4))

        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(()))

        def get_image_features(self, pix):
            return pix.mean(dim=(1, 2))[:, :4].abs() + 1.0

    _, reward = trf.AestheticReward(Unit(), head)(
        torch.from_numpy(_frames(rng, (1, 2, 4, 4, 3))))
    assert float(reward) == 0.25


def test_trap_mps_condition_mask_divides_by_the_batch_global_max(rng):
    """Sample 1's similarities are 1e6 times smaller than sample 0's: against
    the batch-global max every token of sample 1 is masked (-inf), which a
    per-sample max would keep."""
    txt = rng.standard_normal((2, 6, 8)).astype(np.float32)
    txt[1] *= 1e-3
    cond = np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
    txt[0] = np.abs(txt[0])
    txt[1] = np.abs(txt[1])
    want = np.asarray(jmps.mps_condition_mask(jnp.asarray(txt),
                                              jnp.asarray(cond)))
    got = _np(tmps.mps_condition_mask(torch.from_numpy(txt),
                                      torch.from_numpy(cond)))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[1]).all() and (got[0] == 0).all()


def test_trap_mps_layer_norm_eps_is_flax_default(rng):
    """The cross model's LayerNorms use eps 1e-6 (Flax), not torch's 1e-5:
    on tokens of variance ~1e-5 the two differ by far more than rounding."""
    x = (1e-2 * rng.standard_normal((1, 5, 1024)) * np.sqrt(0.1)
         ).astype(np.float32)
    ln = tmps._LayerNorm(1024, device="cpu")
    from flax import linen as nn

    want = nn.LayerNorm(use_bias=False).apply(
        {"params": {"scale": jnp.ones(1024)}}, jnp.asarray(x))
    with torch.no_grad():
        got = ln(torch.from_numpy(x))
        torch_default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (1024,), eps=1e-5)
    _close(got, want, 1e-4)
    assert float((torch_default - got).abs().max()) > 1e-2


def test_reward_and_training_modules_need_no_transformers():
    """The card machine has no transformers (nor jax / flax): the new
    modules import and a CLIP score runs with them unimportable."""
    code = (
        "import sys\n"
        "for m in ('transformers', 'jax', 'flax', 'easyanimate_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "from easyanimate_tpu_torch import train_lcm_lora, train_reward_lora, train_vae\n"
        "from easyanimate_tpu_torch.reward import clip, mps, reward_fn\n"
        "from easyanimate_tpu_torch.training import lcm, reward, vae_losses, vae_trainer\n"
        "cfg = clip.CLIPConfig(clip.CLIPTextConfig(vocab_size=50, hidden_size=8,"
        " intermediate_size=16, num_hidden_layers=1, num_attention_heads=2,"
        " eos_token_id=49),"
        " clip.CLIPVisionConfig(hidden_size=8, intermediate_size=16,"
        " num_hidden_layers=1, num_attention_heads=2, image_size=16,"
        " patch_size=8), projection_dim=4)\n"
        "class Tok:\n"
        "    model_max_length = 77\n"
        "    def __call__(self, p, **kw):\n"
        "        import numpy as np\n"
        "        ids = np.full((len(p), kw['max_length']), 49)\n"
        "        return {'input_ids': ids, 'attention_mask': np.ones_like(ids)}\n"
        "s = reward_fn.CLIPScoreReward(clip.CLIPModel(cfg, device='cpu'), Tok())\n"
        "print(bool(torch.isfinite(s(torch.rand(1, 2, 16, 16, 3), ['a'])[1])))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "True", out.stderr

