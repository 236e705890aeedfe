"""The prompt encoders: the V5.1 Qwen2-VL tower, and V5's Bert and mT5
towers."""
from .bert import TINY_BERT, BertConfig, BertModel
from .encoders import (BertTextEncoder, MT5TextEncoder, QwenVLTextEncoder,
                       build_text_encoder)
from .qwen2 import (TINY_QWEN, Qwen2Config, Qwen2TextEncoder,
                    load_qwen2_state_dict)
from .t5 import TINY_T5, MT5EncoderModel, T5Config

__all__ = ["BertConfig", "BertModel", "BertTextEncoder", "MT5EncoderModel",
           "MT5TextEncoder", "Qwen2Config", "Qwen2TextEncoder",
           "QwenVLTextEncoder", "T5Config", "TINY_BERT", "TINY_QWEN",
           "TINY_T5", "build_text_encoder", "load_qwen2_state_dict"]
