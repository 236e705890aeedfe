"""LCM-LoRA distillation driver on one GPU.

    python -m easyanimate_tpu_torch.train_lcm_lora --model_path <V5.1 dir> \\
        --train_data_meta train.json [--train_data_dir d] \\
        [--output_dir runs/train_lcm] [--lora_rank 64] [--tiny_demo]

Parity: examples/train_lcm_lora.py of the JAX package (reference
scripts/train_lcm_lora.py), with its flags and defaults: consistency
distillation of the frozen teacher into a LoRA student with an EMA target
(training/lcm.py). The real path loads the V5.1 directory with
load_pipeline, reads 49-frame 384x672 clips through data/ (aspect buckets,
the threaded loader), encodes them with the VAE (a posterior sample times
scaling_factor) and the prompts with the directory's text encoder; the
batch also carries the 3D RoPE tables, as train.py's does. The trained
LoRA is saved with save_lora as <output_dir>/lcm_lora.npz (+ .json).
--tiny_demo distils a tiny random MMDiT on random latents.

Runs on the card unless main(device=...) asks for another device.
"""
import argparse
import os

import numpy as np
import torch

from .device import resolve_device
from .pipeline.schedulers import DDIMConfig
from .training.lcm import LCMConfig, make_lcm_train_step
from .training.lora import LoRAConfig, save_lora
from .training.trainer import TrainConfig
from .utils.observability import MetricLogger


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m easyanimate_tpu_torch.train_lcm_lora",
        description="LCM-LoRA distillation of the EasyAnimate MMDiT")
    ap.add_argument("--train_data_meta", default=None)
    ap.add_argument("--train_data_dir", default=None)
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--output_dir", default="runs/train_lcm")
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--lora_rank", type=int, default=64)
    ap.add_argument("--num_ddim_timesteps", type=int, default=50)
    ap.add_argument("--w_min", type=float, default=3.0)
    ap.add_argument("--w_max", type=float, default=15.0)
    ap.add_argument("--ema_decay", type=float, default=0.95)
    ap.add_argument("--max_train_steps", type=int, default=100)
    ap.add_argument("--train_batch_size", type=int, default=1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny_demo", action="store_true")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.tiny_demo:
        args.max_train_steps = 3
        args.num_ddim_timesteps = 10
        args.lora_rank = 2
    return args


def _tiny_batches(args, text_dim: int, device):
    rng = np.random.default_rng(args.seed)
    for _ in range(args.max_train_steps):
        lat = rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
        txt = rng.standard_normal((1, 5, text_dim)).astype(np.float32)
        yield {"latents": torch.from_numpy(lat).to(device),
               "text": torch.from_numpy(txt).to(device)}


def _data_batches(args, pipe, encode_text, device):
    """Clips from the manifest -> VAE posterior samples x scaling_factor,
    prompts -> text embeddings, + RoPE."""
    from .data import (AspectRatioBatchSampler, DataLoader, ImageVideoDataset,
                       ResumableRandomSampler, to_device)
    from .models.vae import gaussian_sample, vae_encode
    from .pipeline.t2v import build_rope

    height, width, frames = 384, 672, 49
    dataset = ImageVideoDataset(args.train_data_meta, args.train_data_dir,
                                video_sample_n_frames=frames, height=height,
                                width=width, seed=args.seed)
    sampler = ResumableRandomSampler(len(dataset), seed=args.seed)
    loader = DataLoader(dataset, AspectRatioBatchSampler(
        sampler=sampler, batch_size=args.train_batch_size,
        sample_info=dataset.sample_info()), num_workers=2)
    vae, model = pipe.vae, pipe.transformer
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    it = iter(loader)
    try:
        for _ in range(args.max_train_steps):
            loaded = next(it)
            pixels = to_device({"p": np.asarray(loaded["pixel_values"],
                                                np.float32)}, device)["p"]
            with torch.no_grad():
                moments = vae_encode(vae, (pixels * 2.0 - 1.0).to(
                    vae.cfg.torch_dtype))
                latents = (gaussian_sample(moments, gen).float()
                           * vae.cfg.scaling_factor)
            yield {"latents": latents,
                   "text": encode_text(loaded["text"])["text"],
                   "rope": build_rope(model.cfg, height, width,
                                      latents.shape[2],
                                      vae_scale=vae.cfg.spatial_compression,
                                      device=device)}
    finally:
        it.close()


def main(argv=None, device=None):
    """Parse `argv` (sys.argv[1:] by default), build or load the models on
    `device` (the card by default) and distil; returns {"state", "losses",
    "lora_path"}."""
    args = parse_args(argv)
    device = resolve_device(device)
    if args.tiny_demo:
        from .train import _tiny_models

        model, _ = _tiny_models(False, device=device, seed=0)
        batches = _tiny_batches(args, model.cfg.text_embed_dim, device)
    else:
        if not args.model_path:
            raise SystemExit("pass --model_path or --tiny_demo")
        if not args.train_data_meta:
            raise SystemExit("pass --train_data_meta (json manifest)")
        from .loader import load_pipeline, load_text_encoders

        pipe = load_pipeline(args.model_path, "t2v", device=device)
        model = pipe.transformer
        encode_text = load_text_encoders(args.model_path, device=device)
        batches = _data_batches(args, pipe, encode_text, device)

    lcfg = LoRAConfig(rank=args.lora_rank)
    init_fn, step_fn = make_lcm_train_step(
        model, DDIMConfig(),
        LCMConfig(num_ddim_timesteps=args.num_ddim_timesteps,
                  w_min=args.w_min, w_max=args.w_max,
                  ema_decay=args.ema_decay),
        lcfg, TrainConfig(learning_rate=args.learning_rate))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_fn(gen)

    logger = MetricLogger(args.output_dir)
    losses = []
    try:
        for step, batch in enumerate(batches):
            state, metrics = step_fn(state, batch, generator=gen)
            logged = logger.log(step, metrics)
            losses.append(logged["loss"])
            print(f"step {step}: loss={logged['loss']:.5f}", flush=True)
    finally:
        logger.close()
    path = os.path.join(args.output_dir, "lcm_lora.npz")
    save_lora(path, state.params, lcfg)
    print("saved", path)
    return {"state": state, "losses": losses, "lora_path": path}


if __name__ == "__main__":
    main()
