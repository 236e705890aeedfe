"""Prompt encoders.

Parity: easyanimate_tpu/models/text/encoders.py (pipeline encode_prompt,
pipeline_easyanimate.py:377-463), one class per edition's tower:
  - V5.1: QwenVLTextEncoder, the Qwen2-VL chat template and
    hidden_states[-2] of the tower in qwen2.py;
  - V5 (and V4): BertTextEncoder (bert.py, 77 tokens) and MT5TextEncoder
    (t5.py, 256 tokens), each the tower's last_hidden_state, in float32
    as the JAX package runs them (Flax's default dtype).

`encode_ids(input_ids, attention_mask)` runs a tower on token ids and
needs nothing outside the port. `__call__(prompts)` is the tokenizer path:
it needs the tokenizer files of the model directory and `transformers`,
which `from_pretrained` imports only when those files are there.
"""
import dataclasses
import os
from typing import Optional, Sequence

import torch
from torch import nn

from ..convert import load_on_device, read_json
from ...utils.safetensors_io import load_dir
from .bert import BertConfig, BertModel, bert_state_dict
from .qwen2 import Qwen2Config, Qwen2TextEncoder, qwen2_state_dict
from .t5 import MT5EncoderModel, T5Config, t5_state_dict

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json",
                    "vocab.txt", "spiece.model")


def _load_tokenizer(path: str):
    """The directory's tokenizer through transformers, or None when the
    directory holds no tokenizer files."""
    if not any(os.path.exists(os.path.join(path, f))
               for f in _TOKENIZER_FILES):
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path, local_files_only=True)


class _IdsEncoder:
    """encode_ids and the plain tokenizer path (right padding to
    max_length, truncation) shared by the towers that return their last
    hidden state for token ids."""

    encoder: nn.Module
    tokenizer: Optional[object]
    max_length: int

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    @torch.no_grad()
    def encode_ids(self, input_ids, attention_mask):
        """Token ids [B, S] and their 0/1 mask (right-padded, as the
        tokenizer pads; tensors or numpy arrays) -> (embeds [B, S, D],
        mask [B, S]) on the tower's device. Under no_grad, not
        inference_mode: the embeddings feed training steps whose text
        projections train, and an inference tensor cannot be saved for a
        backward."""
        ids = torch.as_tensor(input_ids, device=self.device).long()
        mask = torch.as_tensor(attention_mask, device=self.device)
        return self.encoder(ids, mask), mask

    def _tokenize(self, texts: Sequence[str], **kw):
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer: the model directory holds no "
                               "tokenizer files; use encode_ids")
        return self.tokenizer(list(texts), padding="max_length",
                              max_length=self.max_length, truncation=True,
                              return_tensors="pt", **kw)

    def __call__(self, prompts: Sequence[str]):
        ids = self._tokenize(prompts)
        return self.encode_ids(ids["input_ids"], ids["attention_mask"])


def _tower_from_dir(cls, cfg, state_dict_fn, path: str, device):
    """A tower of `cfg` built on meta and filled on `device` from every
    `*.safetensors` under `path`, through state_dict_fn."""
    tower = cls(cfg, device="meta")
    load_on_device(tower, state_dict_fn(tower, load_dir(path)), device)
    return tower


@dataclasses.dataclass
class BertTextEncoder(_IdsEncoder):
    """V5's first prompt stream: the Bert tower's last_hidden_state."""

    encoder: BertModel
    tokenizer: Optional[object] = None
    max_length: int = 77

    @classmethod
    def from_pretrained(cls, path: str, device=None, **kw):
        """The tower from the HF BertModel files under `path` (widths from
        its config.json, as transformers reads them), float32, on `device`
        (the card by default); the tokenizer if its files are in `path`."""
        cfg = BertConfig.from_json(
            read_json(os.path.join(path, "config.json")))
        return cls(encoder=_tower_from_dir(BertModel, cfg, bert_state_dict,
                                           path, device),
                   tokenizer=_load_tokenizer(path), **kw)


@dataclasses.dataclass
class MT5TextEncoder(_IdsEncoder):
    """V5's second prompt stream (V1-V3's only one): the mT5 encoder's
    last_hidden_state."""

    encoder: MT5EncoderModel
    tokenizer: Optional[object] = None
    max_length: int = 256

    @classmethod
    def from_pretrained(cls, path: str, device=None, **kw):
        """The encoder from the HF MT5 files under `path` (an encoder-only
        or a full seq2seq checkpoint; widths from its config.json), float32,
        on `device` (the card by default); the tokenizer if its files are
        in `path`."""
        cfg = T5Config.from_json(
            read_json(os.path.join(path, "config.json")))
        return cls(encoder=_tower_from_dir(MT5EncoderModel, cfg,
                                           t5_state_dict, path, device),
                   tokenizer=_load_tokenizer(path), **kw)


@dataclasses.dataclass
class QwenVLTextEncoder(_IdsEncoder):
    """V5.1 prompt encoding: chat template + hidden_states[-2]."""

    encoder: Qwen2TextEncoder
    tokenizer: Optional[object] = None
    max_length: int = 256

    @classmethod
    def from_pretrained(cls, path: str, cfg: Qwen2Config = Qwen2Config(),
                        device=None, **kw):
        """The tower from every `*.safetensors` under `path` (the widths of
        `cfg`, Qwen2-VL-7B's by default whatever the directory's config.json
        says, as in JAX), built on meta and filled on `device` (the card by
        default); the tokenizer if its files are in `path`."""
        return cls(encoder=_tower_from_dir(Qwen2TextEncoder, cfg,
                                           qwen2_state_dict, path, device),
                   tokenizer=_load_tokenizer(path), **kw)

    def __call__(self, prompts: Sequence[str]):
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer: the model directory holds no "
                               "tokenizer files; use encode_ids")
        texts = [self.tokenizer.apply_chat_template(
            [{"role": "user", "content": [{"type": "text", "text": p}]}],
            tokenize=False, add_generation_prompt=True) for p in prompts]
        ids = self._tokenize(texts, padding_side="right")
        return self.encode_ids(ids["input_ids"], ids["attention_mask"])


_ENCODERS = {"bert": BertTextEncoder, "mt5": MT5TextEncoder,
             "qwen2_vl": QwenVLTextEncoder}


def build_text_encoder(kind: str, path: str, **kw):
    """"bert", "mt5" or "qwen2_vl" from the tower's directory."""
    if kind not in _ENCODERS:
        raise KeyError(kind)
    return _ENCODERS[kind].from_pretrained(path, **kw)
