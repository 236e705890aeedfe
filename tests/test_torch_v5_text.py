"""Parity of the port's V5 prompt towers (easyanimate_tpu_torch/models/text/
bert.py, t5.py) with the transformers Flax towers the JAX package runs
(FlaxBertModel, FlaxMT5EncoderModel), on tiny configs in float32 on the
CPU.

Each Flax tower is initialised from a seed and every parameter perturbed
with numpy draws, so biases and norm scales are exercised; the port gets
the same numbers through the shared Flax converter
(models/convert.py::state_dict_from_flax) or through an HF-layout
checkpoint. Right-padded masks, as the tokenizers pad; the outputs agree
at every position, padded ones included, to test_torch_text.py's atol
1e-5 and rtol 1e-4 (float32 sums in another order). The mT5 case has 2
blocks, so block 0's bias is reused, and 140 tokens: past the 8 exact
offsets and past max distance 128, so the log buckets and their clamp run.
The towers' random weights are the port's, carried into the Flax
modules by the inverse of the port's converter (no Flax init, which costs
seconds); the HF checkpoints are the port's names plus what HF files
carry beside them (the `bert.` prefix, the pooler, position_ids, the tied
`encoder.embed_tokens`, a full model's decoder and lm_head).
"""
import json
import types

import jax
import numpy as np
import pytest
import torch

from easyanimate_tpu.models.text import encoders as jenc
from easyanimate_tpu_torch import loader
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  save_reference_checkpoint,
                                                  state_dict_from_flax)
from easyanimate_tpu_torch.models.text import (TINY_BERT, TINY_T5, BertModel,
                                               BertTextEncoder,
                                               MT5EncoderModel, MT5TextEncoder,
                                               build_text_encoder)
from easyanimate_tpu_torch.models.text import bert as tbert
from easyanimate_tpu_torch.models.text import t5 as tt5
from tests.test_text_encoders import _FakeSPTokenizer

transformers = pytest.importorskip("transformers")

ATOL, RTOL = 1e-5, 1e-4
T5_LEN = 140


def _hf_bert_config():
    c = TINY_BERT
    return transformers.BertConfig(
        vocab_size=c.vocab_size, hidden_size=c.hidden_size,
        num_hidden_layers=c.num_hidden_layers,
        num_attention_heads=c.num_attention_heads,
        intermediate_size=c.intermediate_size,
        max_position_embeddings=c.max_position_embeddings)


def _hf_mt5_config():
    c = TINY_T5
    return transformers.MT5Config(
        vocab_size=c.vocab_size, d_model=c.d_model, d_kv=c.d_kv, d_ff=c.d_ff,
        num_layers=c.num_layers, num_heads=c.num_heads)


def _random_port_sd(cls, cfg, seed):
    """The port tower's state dict: init_random_ (N(0, 1/fan_in), unit
    norms, zero biases), then every tensor perturbed, so biases and norm
    scales are exercised."""
    gen = torch.Generator().manual_seed(seed)
    tower = init_random_(cls(cfg, device="cpu"), gen)
    return {k: v + 0.1 * torch.randn(v.shape, generator=gen)
            for k, v in tower.state_dict().items()}


def to_flax(sd, norm_scale):
    """The port's state dict -> Flax params (nested dicts; Linear weights
    transposed to kernels, embeddings' `embedding`, LayerNorm weights
    `scale` where the Flax module calls them so): the inverse of the
    port's converters, so that no Flax init is needed."""
    out = {}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        a = v.numpy()
        if path[-1].endswith(("embeddings", "shared", "relative_attention_bias")):
            leaf = "embedding"
        elif leaf == "weight" and a.ndim == 2:
            leaf, a = "kernel", a.T
        elif leaf == "weight" and norm_scale(path):
            leaf = "scale"
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a)
    return out


_FLAX = {}


def flax_bert():
    """(FlaxBertModel, the port's random weights as its params), built
    once without a Flax init."""
    if "bert" not in _FLAX:
        sd = _random_port_sd(BertModel, TINY_BERT, 1)
        params = to_flax(sd, lambda path: path[-1] == "LayerNorm")
        pooler = {"dense": {"kernel": np.eye(TINY_BERT.hidden_size,
                                             dtype=np.float32),
                            "bias": np.zeros(TINY_BERT.hidden_size,
                                             np.float32)}}
        m = transformers.FlaxBertModel(_hf_bert_config(), _do_init=False)
        _FLAX["bert"] = m, {**params, "pooler": pooler}
    return _FLAX["bert"]


def flax_mt5():
    if "mt5" not in _FLAX:
        sd = _random_port_sd(MT5EncoderModel, TINY_T5, 2)
        m = transformers.FlaxMT5EncoderModel(_hf_mt5_config(), _do_init=False)
        _FLAX["mt5"] = m, to_flax(sd, lambda path: False)
    return _FLAX["mt5"]


def right_padded(vocab, valid, seq, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (len(valid), seq)).astype(np.int64)
    mask = (np.arange(seq)[None] < np.array(valid)[:, None]).astype(np.int64)
    return np.where(mask == 1, ids, 0), mask


def jitted(model, params):
    """The Flax tower on `params` under jax.jit, called as the JAX
    package's encoders call a transformers model (input_ids=,
    attention_mask= -> .last_hidden_state): one compile per shape instead
    of seconds of op-by-op dispatch."""
    fwd = jax.jit(lambda ids, mask: model(
        input_ids=ids, attention_mask=mask, params=params).last_hidden_state)
    return lambda input_ids, attention_mask: types.SimpleNamespace(
        last_hidden_state=fwd(input_ids, attention_mask))


def flax_out(model, params, ids, mask):
    return np.asarray(jitted(model, params)(ids, mask).last_hidden_state)


def bert_port_sd(params):
    """The Flax Bert's params as the tower's state dict: the shared Flax
    converter, then bert_state_dict, which drops the pooler by name."""
    return tbert.bert_state_dict(BertModel(TINY_BERT, device="meta"),
                                 state_dict_from_flax(params))


def port_tower(cls, cfg, sd):
    tower = cls(cfg, device="cpu")
    tower.load_state_dict(sd, strict=True)
    return tower


def hf_bert_sd(params, prefix="bert."):
    """An HF BertModel checkpoint's tensors under `prefix`: the tower's
    (the Flax tower's values), the pooler's and the position_ids buffer
    that older checkpoints carry."""
    sd = state_dict_from_flax(params)
    d = TINY_BERT.hidden_size
    sd.update({"pooler.dense.weight": torch.randn(d, d),
               "pooler.dense.bias": torch.randn(d),
               "embeddings.position_ids":
                   torch.arange(TINY_BERT.max_position_embeddings)[None]})
    return {prefix + k: v for k, v in sd.items()}


def hf_mt5_sd(params, seq2seq=False):
    """An HF MT5 checkpoint's tensors holding the Flax tower's values:
    MT5EncoderModel's (`shared` and its tied `encoder.embed_tokens`), or
    with seq2seq a full model's, whose decoder.* and lm_head.* are
    random."""
    sd = state_dict_from_flax(params)
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"].clone()
    if seq2seq:
        d = TINY_T5.d_model
        sd.update({"decoder.embed_tokens.weight": sd["shared.weight"].clone(),
                   "decoder.block.0.layer.1.EncDecAttention.q.weight":
                       torch.randn(TINY_T5.inner_dim, d),
                   "decoder.final_layer_norm.weight": torch.ones(d),
                   "lm_head.weight": torch.randn(TINY_T5.vocab_size, d)})
    return sd


def test_bert_matches_flax_at_every_position():
    model, params = flax_bert()
    ids, mask = right_padded(TINY_BERT.vocab_size, (12, 5), 12, seed=3)
    want = flax_out(model, params, ids, mask)
    tower = port_tower(BertModel, TINY_BERT, bert_port_sd(params))
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 12, TINY_BERT.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # and with no mask: every key visible
    with torch.no_grad():
        got = tower(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, flax_out(model, params, ids,
                                             np.ones_like(mask)),
                               atol=ATOL, rtol=RTOL)


def test_mt5_matches_flax_at_every_position_past_the_exact_buckets():
    model, params = flax_mt5()
    ids, mask = right_padded(TINY_T5.vocab_size, (T5_LEN, 37), T5_LEN, seed=4)
    want = flax_out(model, params, ids, mask)
    sd = state_dict_from_flax(params)
    # block 0 alone holds the bias table: the other blocks reuse its bias
    assert [k for k in sd if "relative_attention_bias" in k] == [
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    tower = port_tower(MT5EncoderModel, TINY_T5, sd)
    with torch.no_grad():
        got = tower(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, T5_LEN, TINY_T5.d_model)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_relative_buckets_match_flax():
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    rel = np.arange(-300, 301)[None, :] - np.arange(5)[:, None]
    want = np.asarray(FlaxT5Attention._relative_position_bucket(
        rel, bidirectional=True, num_buckets=32, max_distance=128))
    got = tt5.relative_position_bucket(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # every bucket but 16 (a positive offset of 0) is reached
    assert set(np.unique(want).tolist()) == set(range(32)) - {16}


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_bert_hf_checkpoint_loads_and_drops_only_the_pooler(prefix):
    """transformers' BertModel key set, with or without `bert.`: the pooler
    is dropped by name, position_ids is checked and dropped; any other
    stray key, or a missing tower tensor, raises."""
    _, params = flax_bert()
    sd = hf_bert_sd(params, prefix)
    assert {prefix + k for k in tbert.BERT_DROPPED} <= set(sd)
    tower = BertModel(TINY_BERT, device="cpu")
    got = tbert.bert_state_dict(tower, sd)
    want = bert_port_sd(params)
    assert set(got) == set(want) == set(tower.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)
    for bad, match in (({**sd, prefix + "cls.predictions.bias":
                         torch.zeros(3)}, "unexpected"),
                       ({k: v for k, v in sd.items()
                         if not k.endswith("layer.1.output.dense.bias")},
                        "missing")):
        with pytest.raises(KeyError, match=match):
            tbert.bert_state_dict(tower, bad)
    with pytest.raises(ValueError, match="position_ids"):
        tbert.bert_state_dict(tower, {
            **sd, prefix + "embeddings.position_ids":
                torch.zeros(1, TINY_BERT.max_position_embeddings)})


@pytest.mark.parametrize("layout", ["encoder", "shared_only",
                                    "embed_tokens_only", "seq2seq"])
def test_mt5_hf_checkpoint_traps(layout):
    """The tied embedding (safetensors often keeps `shared` alone; either
    one fills the tower's `shared`) and a full seq2seq checkpoint's
    decoder.* and lm_head.*, dropped by name; a stray key raises."""
    _, params = flax_mt5()
    sd = hf_mt5_sd(params, seq2seq=layout == "seq2seq")
    assert {"shared.weight", "encoder.embed_tokens.weight"} <= set(sd)
    if layout == "shared_only":
        del sd["encoder.embed_tokens.weight"]
    elif layout == "embed_tokens_only":
        del sd["shared.weight"]
    elif layout == "seq2seq":
        assert any(k.startswith("decoder.") for k in sd) and "lm_head.weight" in sd
    tower = MT5EncoderModel(TINY_T5, device="cpu")
    got = tt5.t5_state_dict(tower, sd)
    want = state_dict_from_flax(params)
    assert set(got) == set(want) == set(tower.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(KeyError, match="unexpected"):
        tt5.t5_state_dict(tower, {**sd, "encoder.block.1.layer.0.SelfAttention"
                                  ".relative_attention_bias.weight":
                                  torch.zeros(32, TINY_T5.num_heads)})
    with pytest.raises(KeyError, match="missing"):
        tt5.t5_state_dict(tower, {k: v for k, v in sd.items()
                                  if k not in ("shared.weight",
                                               "encoder.embed_tokens.weight")})


def _bert_tokenizer(path):
    """A local BertTokenizer vocabulary (ids below TINY_BERT's 64 rows)."""
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat",
             "walks", "on", "the", "grass", "video", "blurry", "low",
             "quality"]
    path.mkdir(parents=True, exist_ok=True)
    (path / "vocab.txt").write_text("\n".join(words))
    tok = transformers.BertTokenizer(str(path / "vocab.txt"))
    tok.save_pretrained(str(path))
    return tok


def _word_tokenizer(path, vocab_size):
    """A word-level fast tokenizer (no sentencepiece files can be made
    offline), saved under `path`; ids below vocab_size."""
    tokenizers = pytest.importorskip("tokenizers")
    words = "a the cat walks on grass video blurry low quality </s>".split()
    vocab = {"<pad>": 0, "<unk>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    assert len(vocab) < vocab_size
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, "<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>")
    fast.save_pretrained(str(path))
    return fast


PROMPTS = ["a cat walks on the grass", "blurry low quality"]


def test_bert_prompt_path_matches_jax_with_a_local_tokenizer(tmp_path):
    """from_pretrained on an HF-layout directory (config.json, safetensors
    under the `bert.` prefix with the pooler, vocab.txt): __call__(prompts)
    pads to 77 as JAX's BertTextEncoder does, and agrees with it."""
    model, params = flax_bert()
    tok = _bert_tokenizer(tmp_path)
    save_reference_checkpoint(str(tmp_path), hf_bert_sd(params),
                              _hf_bert_config().to_dict(),
                              weights_name="model.safetensors")
    enc = build_text_encoder("bert", str(tmp_path), device="cpu")
    assert enc.max_length == 77 and enc.encoder.cfg == TINY_BERT
    emb, mask = enc(PROMPTS)
    jemb, jmask = jenc.BertTextEncoder(
        model=jitted(model, params), tokenizer=tok)(PROMPTS)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.shape == (2, 77) and mask.sum(1).tolist() == [8, 5]
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL,
                               rtol=RTOL)


def test_mt5_prompt_path_matches_jax_with_the_sp_stand_in():
    """__call__(prompts) through JAX's duck-typed SentencePiece stand-in
    (numpy ids), against JAX's MT5TextEncoder on the same tokenizer."""
    model, params = flax_mt5()
    tower = port_tower(MT5EncoderModel, TINY_T5, state_dict_from_flax(params))
    prompts = ["a cat", "a longer test prompt here"]
    enc = MT5TextEncoder(tower, tokenizer=_FakeSPTokenizer(), max_length=10)
    emb, mask = enc(prompts)
    jemb, jmask = jenc.MT5TextEncoder(
        model=jitted(model, params), tokenizer=_FakeSPTokenizer(),
        max_length=10)(prompts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum(1).tolist() == [2, 5]
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL,
                               rtol=RTOL)


def write_v5_text_dirs(root, max_shard_bytes=30_000):
    """text_encoder (Bert: config.json, sharded safetensors with the
    `bert.` prefix and pooler, vocab.txt) and text_encoder_2 (mT5:
    config.json, `shared` without `encoder.embed_tokens`, a word-level
    tokenizer) under `root`, written by the port; returns the Flax
    towers' (model, params) and the tokenizers."""
    (bm, bp), (mm, mp) = flax_bert(), flax_mt5()
    te, te2 = root / "text_encoder", root / "text_encoder_2"
    btok = _bert_tokenizer(te)
    save_reference_checkpoint(str(te), hf_bert_sd(bp),
                              _hf_bert_config().to_dict(),
                              max_shard_bytes=max_shard_bytes,
                              weights_name="model.safetensors")
    mtok = _word_tokenizer(te2, TINY_T5.vocab_size)
    sd = hf_mt5_sd(mp)
    del sd["encoder.embed_tokens.weight"]
    save_reference_checkpoint(str(te2), sd, _hf_mt5_config().to_dict(),
                              weights_name="model.safetensors")
    return (bm, bp, btok), (mm, mp, mtok)


def test_load_text_encoders_reads_a_port_written_dual_stream_directory(
        tmp_path):
    """The V5 layout: load_text_encoders gives {"text", "text_t5"}, Bert at
    its 77 tokens and mT5 at max_length, each equal to its Flax tower on
    the same tokenizer's ids; text_encoder_path / text_encoder_2_path and
    the single-stream T5 layout too."""
    (bm, bp, btok), (mm, mp, mtok) = write_v5_text_dirs(tmp_path)
    assert json.loads((tmp_path / "text_encoder" / "config.json")
                      .read_text())["model_type"] == "bert"
    encode = loader.load_text_encoders(str(tmp_path), max_length=12,
                                       device="cpu")
    out = encode(PROMPTS)
    assert set(out) == {"text", "text_t5"}
    assert out["text"].shape == (2, 77, TINY_BERT.hidden_size)
    assert out["text_t5"].shape == (2, 12, TINY_T5.d_model)
    b = btok(PROMPTS, padding="max_length", max_length=77, truncation=True,
             return_tensors="np")
    m = mtok(PROMPTS, padding="max_length", max_length=12, truncation=True,
             return_tensors="np")
    np.testing.assert_allclose(
        out["text"].numpy(),
        flax_out(bm, bp, b["input_ids"], b["attention_mask"]),
        atol=ATOL, rtol=RTOL)
    want_t5 = flax_out(mm, mp, m["input_ids"], m["attention_mask"])
    np.testing.assert_allclose(out["text_t5"].numpy(), want_t5, atol=ATOL,
                               rtol=RTOL)
    # the paths apart, and the mT5 directory as a single T5 stream (V1-V3)
    encode = loader.load_text_encoders(
        text_encoder_path=str(tmp_path / "text_encoder"),
        text_encoder_2_path=str(tmp_path / "text_encoder_2"), max_length=12,
        device="cpu")
    np.testing.assert_array_equal(encode(PROMPTS)["text_t5"].numpy(),
                                  out["text_t5"].numpy())
    single = loader.load_text_encoders(
        text_encoder_path=str(tmp_path / "text_encoder_2"), max_length=12,
        device="cpu")(PROMPTS)
    assert set(single) == {"text"}
    np.testing.assert_array_equal(single["text"].numpy(),
                                  out["text_t5"].numpy())


@pytest.mark.parametrize("kind", ["bert", "qwen2_vl"])
def test_embeddings_feed_a_trained_projection(kind):
    """The towers' embeddings are ordinary tensors, not inference ones: a
    full fine-tune (train.py without --lora_rank) trains text_proj (and
    V5's text_proj_t5) on them, and their backward saves its input."""
    from easyanimate_tpu_torch.models.text import (TINY_QWEN,
                                                   Qwen2TextEncoder,
                                                   QwenVLTextEncoder)

    if kind == "bert":
        _, params = flax_bert()
        enc = BertTextEncoder(port_tower(
            BertModel, TINY_BERT, bert_port_sd(params)))
        vocab, dim = TINY_BERT.vocab_size, TINY_BERT.hidden_size
    else:
        enc = QwenVLTextEncoder(init_random_(
            Qwen2TextEncoder(TINY_QWEN, device="cpu"),
            torch.Generator().manual_seed(0)))
        vocab, dim = TINY_QWEN.vocab_size, TINY_QWEN.hidden_size
    ids, mask = right_padded(vocab, (6, 3), 6, seed=7)
    emb, _ = enc.encode_ids(ids, mask)
    assert not emb.is_inference() and not emb.requires_grad
    proj = torch.nn.Linear(dim, 4)
    proj(emb).square().sum().backward()
    assert proj.weight.grad is not None


def test_trap_umt5_is_refused_by_name(tmp_path):
    """UMT5 holds a relative_attention_bias table in every block; the mT5
    tower (as the JAX package's Flax mT5) reads block 0's alone. A umt5
    directory is refused before any weight is read, with the reason, not
    left to fail on the other blocks' tables as stray keys."""
    te = tmp_path / "text_encoder"
    te.mkdir()
    (te / "config.json").write_text(json.dumps(
        {**_hf_mt5_config().to_dict(), "model_type": "umt5"}))
    with pytest.raises(NotImplementedError, match="every block"):
        loader.load_text_encoders(text_encoder_path=str(te), device="cpu")
    with pytest.raises(NotImplementedError, match="umt5"):
        build_text_encoder("mt5", str(te), device="cpu")
