"""The V5.1 prompt encoder: the Qwen2-VL text tower."""
from .encoders import QwenVLTextEncoder, build_text_encoder
from .qwen2 import (TINY_QWEN, Qwen2Config, Qwen2TextEncoder,
                    load_qwen2_state_dict)

__all__ = ["Qwen2Config", "Qwen2TextEncoder", "QwenVLTextEncoder",
           "TINY_QWEN", "build_text_encoder", "load_qwen2_state_dict"]
