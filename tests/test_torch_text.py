"""Parity of the port's Qwen2-VL text tower
(easyanimate_tpu_torch/models/text/qwen2.py) with the flax Qwen2TextEncoder
of the JAX package, on TINY_QWEN in float32 on the CPU.

Both take the same HF-layout state dict, drawn from a numpy seed; JAX reads
it through its convert_qwen2_state_dict, the port through
load_qwen2_state_dict. Right-padded masks, as the tokenizer pads; the
outputs agree at every position, padded ones included, to atol 1e-5 and
rtol 1e-4 (float32 sums in another order). The prompt-string path (chat
template, tokenizer, right padding) runs with a synthetic word-level
tokenizer, since no Qwen2-VL tokenizer files are in the repository.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models.text import qwen2 as jqwen
from easyanimate_tpu_torch.models.convert import save_reference_checkpoint
from easyanimate_tpu_torch.models.text import (TINY_QWEN, Qwen2Config,
                                               Qwen2TextEncoder,
                                               build_text_encoder,
                                               load_qwen2_state_dict)
from easyanimate_tpu_torch.models.text import qwen2 as tqwen

ATOL, RTOL = 1e-5, 1e-4
JAX_TINY = jqwen.TINY_QWEN


def hf_state_dict(cfg, seed=0, prefix="model."):
    """An HF Qwen2(-VL) checkpoint's keys, float32 numpy: N(0, 1) embeddings,
    N(0, 1/fan_in) linears, N(0, 0.1) biases, norms near 1; plus what the
    tower never reads (final norm, lm_head, a vision tensor)."""
    rng = np.random.default_rng(seed)
    d, f, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    nq, nkv = cfg.num_attention_heads, cfg.num_key_value_heads

    def lin(o, i):
        return (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)

    def vec(n, base=0.0):
        return (base + 0.1 * rng.standard_normal(n)).astype(np.float32)

    sd = {"embed_tokens.weight": rng.standard_normal(
        (cfg.vocab_size, d)).astype(np.float32), "norm.weight": vec(d, 1.0)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        sd.update({
            p + "input_layernorm.weight": vec(d, 1.0),
            p + "post_attention_layernorm.weight": vec(d, 1.0),
            p + "self_attn.q_proj.weight": lin(nq * hd, d),
            p + "self_attn.q_proj.bias": vec(nq * hd),
            p + "self_attn.k_proj.weight": lin(nkv * hd, d),
            p + "self_attn.k_proj.bias": vec(nkv * hd),
            p + "self_attn.v_proj.weight": lin(nkv * hd, d),
            p + "self_attn.v_proj.bias": vec(nkv * hd),
            p + "self_attn.o_proj.weight": lin(d, nq * hd),
            p + "mlp.gate_proj.weight": lin(f, d),
            p + "mlp.up_proj.weight": lin(f, d),
            p + "mlp.down_proj.weight": lin(d, f)})
    out = {prefix + k: v for k, v in sd.items()}
    out["lm_head.weight"] = lin(cfg.vocab_size, d)
    out["visual.patch_embed.proj.weight"] = lin(4, 3)
    return out


def right_padded(cfg, valid=(8, 3), seq=10, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (len(valid), seq)).astype(np.int64)
    mask = (np.arange(seq)[None] < np.array(valid)[:, None]).astype(np.int64)
    return np.where(mask == 1, ids, 0), mask


def jax_encode(sd, ids, mask, drop_last_layer=True):
    enc = jqwen.Qwen2TextEncoder(JAX_TINY, drop_last_layer=drop_last_layer)
    variables = jqwen.convert_qwen2_state_dict(sd, JAX_TINY, drop_last_layer)
    return np.asarray(enc.apply(variables, jnp.asarray(ids), jnp.asarray(mask)))


def port_encoder(sd, drop_last_layer=True):
    enc = Qwen2TextEncoder(TINY_QWEN, drop_last_layer, device="cpu")
    load_qwen2_state_dict(enc, {k: torch.from_numpy(v) for k, v in sd.items()})
    return enc


def test_config_and_rope_match_jax():
    assert {f.name for f in dataclasses.fields(Qwen2Config)} == {
        f.name for f in dataclasses.fields(jqwen.Qwen2Config)} - {"scan_layers"}
    for cfg, jcfg in ((Qwen2Config(), jqwen.Qwen2Config()),
                      (TINY_QWEN, JAX_TINY)):
        for f in dataclasses.fields(Qwen2Config):
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        cos, sin = tqwen.rope_tables(cfg, 300)
        jcos, jsin = jqwen._rope_tables(jcfg, jnp.arange(300))
        # the same float32 angles; the two libraries' cos / sin differ by
        # up to one float32 ulp (6e-8 near 1)
        np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1.2e-7,
                                   rtol=0)
        np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1.2e-7,
                                   rtol=0)


@pytest.mark.parametrize("drop_last_layer", [True, False])
def test_tower_matches_flax_at_every_position(drop_last_layer):
    sd = hf_state_dict(TINY_QWEN)
    ids, mask = right_padded(TINY_QWEN)
    want = jax_encode(sd, ids, mask, drop_last_layer)
    enc = port_encoder(sd, drop_last_layer)
    assert len(enc.layers) == TINY_QWEN.num_hidden_layers - drop_last_layer
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 10, TINY_QWEN.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # and with no mask (causal only)
    want = np.asarray(jqwen.Qwen2TextEncoder(JAX_TINY, drop_last_layer).apply(
        jqwen.convert_qwen2_state_dict(sd, JAX_TINY, drop_last_layer),
        jnp.asarray(ids)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("prefix", tqwen.QWEN2_PREFIXES)
def test_every_accepted_prefix_loads(prefix):
    sd = hf_state_dict(TINY_QWEN, seed=2, prefix=prefix)
    ids, mask = right_padded(TINY_QWEN, seed=3)
    want = jax_encode(sd, ids, mask)
    with torch.no_grad():
        got = port_encoder(sd)(torch.from_numpy(ids),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_missing_tower_tensor_raises():
    sd = hf_state_dict(TINY_QWEN)
    del sd["model.layers.1.self_attn.k_proj.bias"]
    with pytest.raises(KeyError, match="layers.1.self_attn.k_proj.bias"):
        port_encoder(sd)
    # the dropped last layer is never read: its absence is fine
    sd = hf_state_dict(TINY_QWEN)
    last = f"model.layers.{TINY_QWEN.num_hidden_layers - 1}."
    port_encoder({k: v for k, v in sd.items() if not k.startswith(last)})
    with pytest.raises(KeyError):
        port_encoder({k: v for k, v in sd.items() if not k.startswith(last)},
                     drop_last_layer=False)


def test_build_text_encoder_reads_a_port_written_directory(tmp_path):
    sd = hf_state_dict(TINY_QWEN, seed=4, prefix="model.language_model.")
    save_reference_checkpoint(str(tmp_path), sd, {"model_type": "qwen2_vl"},
                              max_shard_bytes=20_000,
                              weights_name="model.safetensors")
    enc = build_text_encoder("qwen2_vl", str(tmp_path), cfg=TINY_QWEN,
                             device="cpu")
    assert enc.tokenizer is None  # no tokenizer files in the directory
    ids, mask = right_padded(TINY_QWEN, valid=(10, 4), seed=5)
    emb, m = enc.encode_ids(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(emb.numpy(), jax_encode(sd, ids, mask),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(m, torch.from_numpy(mask))
    with pytest.raises(RuntimeError, match="tokenizer"):
        enc(["a prompt"])
    # the Bert and mT5 towers are ported and load strictly: a Qwen2
    # directory holds none of their tensors (tests/test_torch_v5_text.py
    # loads their own directories); an unknown kind raises
    for kind, name in (("bert", "Bert"), ("mt5", "T5")):
        with pytest.raises(KeyError, match=f"{name} checkpoint: .* missing"):
            build_text_encoder(kind, str(tmp_path), device="cpu")
    with pytest.raises(KeyError, match="gpt9"):
        build_text_encoder("gpt9", str(tmp_path))


def _word_tokenizer(path):
    """A word-level tokenizer with a Qwen-style chat template, saved as
    tokenizer files under `path` (no Qwen2-VL tokenizer files are in the
    repository); its ids stay inside TINY_QWEN's vocabulary."""
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    words = ("<|im_start|> <|im_end|> user assistant a the cat sat on mat "
             "blurry low quality").split()
    vocab = {"<pad>": 0, "<unk>": 1, **{w: i + 2 for i, w in enumerate(words)}}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, "<unk>"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.WhitespaceSplit()
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>")
    fast.chat_template = (
        "{% for m in messages %}<|im_start|> {{ m['role'] }} "
        "{% for c in m['content'] %}{{ c['text'] }}{% endfor %} <|im_end|> "
        "{% endfor %}{% if add_generation_prompt %}<|im_start|> assistant "
        "{% endif %}")
    fast.save_pretrained(str(path))


def test_prompt_path_matches_jax_with_a_local_tokenizer(tmp_path):
    """__call__(prompts): the chat template, right padding to max_length
    and the tower, against the JAX QwenVLTextEncoder on the same files."""
    from transformers import AutoTokenizer

    from easyanimate_tpu.models.text.encoders import \
        QwenVLTextEncoder as JaxQwenVL

    sd = hf_state_dict(TINY_QWEN, seed=6)
    save_reference_checkpoint(str(tmp_path), sd, None,
                              weights_name="model.safetensors")
    _word_tokenizer(tmp_path)
    enc = build_text_encoder("qwen2_vl", str(tmp_path), cfg=TINY_QWEN,
                             device="cpu", max_length=16)
    assert enc.tokenizer is not None
    prompts = ["the cat sat on the mat", "blurry low quality"]
    emb, mask = enc(prompts)
    jenc = JaxQwenVL(encoder=jqwen.Qwen2TextEncoder(JAX_TINY),
                     variables=jqwen.convert_qwen2_state_dict(sd, JAX_TINY),
                     tokenizer=AutoTokenizer.from_pretrained(
                         str(tmp_path), local_files_only=True),
                     max_length=16)
    jemb, jmask = jenc(prompts)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.sum(1).tolist() == [11, 8]  # template + words, right-padded
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), atol=ATOL,
                               rtol=RTOL)
