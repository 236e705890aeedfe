"""LoRA fine-tuning driver (reference scripts/train_lora.py).

    python -m easyanimate_tpu_torch.train_lora --train_data_meta meta.json \\
        --model_path model_dir [--lora_rank 128]

The same data and loss loop as easyanimate_tpu_torch.train with only the
low-rank factors trainable: --lora_rank defaults to 128, and every other
flag is forwarded (parity: examples/train_lora.py of the JAX package).
"""
import sys

from . import train


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--lora_rank") for a in argv):
        argv += ["--lora_rank", "128"]
    return train.main(argv, device)


if __name__ == "__main__":
    main()
