"""Reward-backprop LoRA driver on one GPU.

    python -m easyanimate_tpu_torch.train_reward_lora --model_path <V5.1 dir> \\
        [--reward brightness|clip|hps|pickscore|aesthetic] \\
        [--reward_model_path <HF CLIP dir>] [--prompt_path prompts.txt] \\
        [--backprop_strategy last|tail|uniform|random] [--tiny_demo]

Parity: examples/train_reward_lora.py of the JAX package (reference
scripts/train_reward_lora.py), with its flags and defaults: run the
sampler with gradients through the selected steps, decode the first latent
frames, backprop a reward into a LoRA (training/reward.py). Each step's
prompt is a random line of --prompt_path; the CLIP-family scorers score
against every line of it (a brightness proxy needs no weights). The
trained LoRA is saved with save_lora as <output_dir>/reward_lora.npz.
MPS stays reachable through reward.mps.MPSReward, as in JAX.

The CLIP-family scorers need a tokenizer: the port carries no tokenizer
library, so the caller passes one to main(tokenizer=...) (the Hugging
Face call interface; see reward/clip.py). The real path's batches carry
the 3D RoPE tables, as train.py's do. Runs on the card unless
main(device=...) asks for another device.
"""
import argparse
import os

import numpy as np
import torch

from .device import resolve_device
from .training.lora import LoRAConfig, save_lora
from .training.reward import RewardConfig, make_reward_train_step
from .training.trainer import TrainConfig
from .utils.observability import MetricLogger


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m easyanimate_tpu_torch.train_reward_lora",
        description="Reward-backprop LoRA fine-tuning of the EasyAnimate MMDiT")
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--output_dir", default="runs/train_reward")
    ap.add_argument("--reward", default="brightness",
                    choices=["brightness", "clip", "hps", "pickscore",
                             "aesthetic"])
    ap.add_argument("--reward_model_path", default=None,
                    help="HF path for the CLIP/HPS/PickScore/aesthetic model")
    ap.add_argument("--prompt_path", default=None,
                    help="newline-separated training prompts")
    ap.add_argument("--learning_rate", type=float, default=1e-5)
    ap.add_argument("--lora_rank", type=int, default=32)
    ap.add_argument("--num_sample_steps", type=int, default=50)
    ap.add_argument("--backprop_strategy", default="last",
                    choices=["last", "tail", "uniform", "random"])
    ap.add_argument("--num_decoded_latents", type=int, default=1)
    ap.add_argument("--guidance_scale", type=float, default=6.0)
    ap.add_argument("--max_train_steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny_demo", action="store_true")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.tiny_demo:
        args.max_train_steps = 2
        args.num_sample_steps = 3
        args.lora_rank = 2
    return args


def _read_prompts(path):
    if not path:
        return None
    with open(path) as f:
        return f.read().splitlines()


def make_reward_fn(args, device, tokenizer=None):
    """frames (B, T, H, W, C) -> reward: the brightness proxy, or a
    CLIP-family scorer from --reward_model_path against every prompt."""
    if args.reward == "brightness":
        # a differentiable proxy for smoke runs
        return lambda frames: torch.mean(frames, dim=(1, 2, 3, 4))
    from .reward import reward_fn as rf

    cls = {"clip": rf.CLIPScoreReward, "hps": rf.HPSReward,
           "pickscore": rf.PickScoreReward,
           "aesthetic": rf.AestheticReward}[args.reward]
    if not args.reward_model_path:
        raise SystemExit("--reward_model_path required for " + args.reward)
    if args.reward == "aesthetic":
        scorer = cls.from_pretrained(args.reward_model_path, device=device)
    else:
        if tokenizer is None:
            raise SystemExit(f"--reward {args.reward} needs a tokenizer: "
                             "pass one to main(tokenizer=...)")
        scorer = cls.from_pretrained(args.reward_model_path, tokenizer,
                                     device=device)
    prompts = _read_prompts(args.prompt_path) or [""]
    return lambda frames: scorer(frames, prompts)[1][None]


def main(argv=None, device=None, tokenizer=None):
    """Parse `argv` (sys.argv[1:] by default), build or load the models on
    `device` (the card by default) and train; returns {"state", "losses",
    "rewards", "lora_path"}."""
    args = parse_args(argv)
    device = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    if args.tiny_demo:
        from .train import _tiny_models

        model, vae = _tiny_models(False, device=device, seed=0)
        latent_shape = (1, 4, 2, 8, 8)
        text_dim = model.cfg.text_embed_dim

        def batches():
            for _ in range(args.max_train_steps):
                txt = rng.standard_normal((1, 5, text_dim)).astype(np.float32)
                yield {"text": torch.from_numpy(txt).to(device),
                       "latent_shape": latent_shape}
    else:
        if not args.model_path:
            raise SystemExit("pass --model_path or --tiny_demo")
        from .loader import load_pipeline, load_text_encoders
        from .pipeline.t2v import build_rope

        pipe = load_pipeline(args.model_path, "t2v", device=device)
        model, vae = pipe.transformer, pipe.vae
        encode_text = load_text_encoders(args.model_path, device=device)
        train_prompts = (_read_prompts(args.prompt_path)
                         or ["a photo of a cat"])
        height, width = 384, 672
        latent_shape = pipe.latent_shape(1, 49, height, width)
        rope = build_rope(model.cfg, height, width, latent_shape[2],
                          vae_scale=vae.cfg.spatial_compression, device=device)

        def batches():
            for _ in range(args.max_train_steps):
                p = train_prompts[int(rng.integers(len(train_prompts)))]
                yield {"text": encode_text([p])["text"],
                       "latent_shape": latent_shape, "rope": rope}

    reward_fn = make_reward_fn(args, device, tokenizer)
    rcfg = RewardConfig(num_sample_steps=args.num_sample_steps,
                        backprop_strategy=args.backprop_strategy,
                        num_decoded_latents=args.num_decoded_latents,
                        guidance_scale=args.guidance_scale)
    lcfg = LoRAConfig(rank=args.lora_rank)
    init_fn, step_fn = make_reward_train_step(
        model, vae, reward_fn, rcfg, lcfg,
        TrainConfig(learning_rate=args.learning_rate),
        vae_scaling=vae.cfg.scaling_factor)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_fn(gen)

    logger = MetricLogger(args.output_dir)
    losses, rewards = [], []
    try:
        for step, batch in enumerate(batches()):
            state, metrics = step_fn(state, batch, generator=gen)
            logged = logger.log(step, metrics)
            losses.append(logged["loss"])
            rewards.append(logged["reward"])
            print(f"step {step}: loss={logged['loss']:.5f} "
                  f"reward={logged['reward']:.4f}", flush=True)
    finally:
        logger.close()
    path = os.path.join(args.output_dir, "reward_lora.npz")
    save_lora(path, state.params, lcfg)
    print("saved", path)
    return {"state": state, "losses": losses, "rewards": rewards,
            "lora_path": path}


if __name__ == "__main__":
    main()
