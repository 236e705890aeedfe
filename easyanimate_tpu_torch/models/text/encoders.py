"""Prompt encoders.

Parity: easyanimate_tpu/models/text/encoders.py (pipeline encode_prompt,
pipeline_easyanimate.py:377-463). Only the V5.1 encoder is ported: the
Qwen2-VL chat template and hidden_states[-2] of the tower in qwen2.py. The
V1-V5 Bert / mT5 encoders are not (ROADMAP queue 1 item 11).

`encode_ids(input_ids, attention_mask)` runs the tower on token ids and
needs nothing outside the port. `__call__(prompts)` is the tokenizer path:
it needs the tokenizer files of the model directory and `transformers`,
which `from_pretrained` imports only when those files are there.
"""
import dataclasses
import os
from typing import Optional, Sequence

import torch

from ..convert import load_on_device
from ...utils.safetensors_io import load_dir
from .qwen2 import Qwen2Config, Qwen2TextEncoder, qwen2_state_dict

_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json")


@dataclasses.dataclass
class QwenVLTextEncoder:
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
        encoder = Qwen2TextEncoder(cfg, device="meta")
        load_on_device(encoder, qwen2_state_dict(encoder, load_dir(path)),
                       device)
        tokenizer = None
        if any(os.path.exists(os.path.join(path, f)) for f in _TOKENIZER_FILES):
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(path,
                                                      local_files_only=True)
        return cls(encoder=encoder, tokenizer=tokenizer, **kw)

    @property
    def device(self) -> torch.device:
        return self.encoder.embed_tokens.weight.device

    @torch.inference_mode()
    def encode_ids(self, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor):
        """Token ids [B, S] and their 0/1 mask (right-padded, as the
        tokenizer pads) -> (embeds [B, S, D], mask [B, S]) on the tower's
        device."""
        ids = input_ids.to(self.device)
        mask = attention_mask.to(self.device)
        return self.encoder(ids, mask), mask

    def __call__(self, prompts: Sequence[str]):
        if self.tokenizer is None:
            raise RuntimeError("no tokenizer: the model directory holds no "
                               "tokenizer files; use encode_ids")
        texts = [self.tokenizer.apply_chat_template(
            [{"role": "user", "content": [{"type": "text", "text": p}]}],
            tokenize=False, add_generation_prompt=True) for p in prompts]
        ids = self.tokenizer(texts, padding="max_length",
                             max_length=self.max_length, truncation=True,
                             padding_side="right", return_tensors="pt")
        return self.encode_ids(ids["input_ids"], ids["attention_mask"])


def build_text_encoder(kind: str, path: str, **kw):
    if kind in ("bert", "mt5"):
        raise NotImplementedError(f"text encoder {kind!r} is not ported "
                                  "(ROADMAP queue 1 item 11)")
    if kind != "qwen2_vl":
        raise KeyError(kind)
    return QwenVLTextEncoder.from_pretrained(path, **kw)
