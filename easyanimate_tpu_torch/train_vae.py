"""MagViT VAE GAN training driver on one GPU.

    python -m easyanimate_tpu_torch.train_vae --train_data_meta train.json \\
        [--train_data_dir d] [--sample_size 256] \\
        [--video_sample_n_frames 17] [--disc_start 50] [--use_ema] \\
        [--tiny_demo]

Parity: examples/train_vae.py of the JAX package (reference
scripts/train_vae.py), with its flags and defaults: reconstruction +
LPIPS + KL + hinge GAN with the adaptive generator weight, alternating
ae / disc steps (training/vae_trainer.py), optional EMA. The full MagViT
(MagvitVAEConfig(), float32), Discriminator3D() and LPIPS (VGG16) start
from random weights drawn from --seed, as the JAX driver inits them; clips
come from the train.py manifest format, square at --sample_size, in
[-1, 1]. --checkpointing_steps is parsed and unused, as in JAX.
--tiny_demo trains tiny random models on random 16 px clips.

Runs on the card unless main(device=...) asks for another device.
"""
import argparse

import numpy as np
import torch

from .device import resolve_device
from .models.convert import init_random_
from .models.vae import AutoencoderKLMagvit, MagvitVAEConfig
from .train import TINY_VAE
from .training.vae_losses import LPIPS, Discriminator3D, VAELossConfig
from .training.vae_trainer import (VAETrainConfig, create_vae_train_state,
                                   make_vae_train_steps)
from .utils.observability import MetricLogger


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m easyanimate_tpu_torch.train_vae",
        description="MagViT VAE GAN training")
    ap.add_argument("--train_data_meta", default=None)
    ap.add_argument("--train_data_dir", default=None)
    ap.add_argument("--output_dir", default="runs/train_vae")
    ap.add_argument("--learning_rate", type=float, default=1e-4)
    ap.add_argument("--disc_learning_rate", type=float, default=1e-4)
    ap.add_argument("--train_batch_size", type=int, default=1)
    ap.add_argument("--video_sample_n_frames", type=int, default=17)
    ap.add_argument("--sample_size", type=int, default=256)
    ap.add_argument("--max_train_steps", type=int, default=100)
    ap.add_argument("--disc_start", type=int, default=50)
    ap.add_argument("--perceptual_weight", type=float, default=1.0)
    ap.add_argument("--kl_weight", type=float, default=1e-6)
    ap.add_argument("--use_ema", action="store_true")
    ap.add_argument("--checkpointing_steps", type=int, default=500)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--tiny_demo", action="store_true")
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    args = build_parser().parse_args(argv)
    if args.tiny_demo:
        args.sample_size, args.video_sample_n_frames = 16, 3
        args.max_train_steps, args.disc_start = 4, 2
        args.perceptual_weight = 0.0
    return args


def build_models(args, device):
    """(vae, disc, lpips or None): random weights from --seed, float32."""
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.tiny_demo:
        vae_cfg, disc = TINY_VAE, Discriminator3D(8, 2, device=device)
    else:
        vae_cfg, disc = MagvitVAEConfig(), Discriminator3D(device=device)
    vae = init_random_(AutoencoderKLMagvit(vae_cfg, device=device), gen)
    init_random_(disc, gen)
    lpips = None
    if args.perceptual_weight > 0:
        lpips = init_random_(LPIPS(device=device), gen).requires_grad_(False)
    return vae, disc, lpips


def _random_batches(args, device):
    """--tiny_demo's clips: 0.5 * N(0, 1) frames from --seed."""
    rng = np.random.default_rng(args.seed)
    s, f = args.sample_size, args.video_sample_n_frames
    while True:
        v = rng.standard_normal((args.train_batch_size, 3, f, s, s))
        yield {"video": torch.from_numpy(v.astype(np.float32) * 0.5).to(device)}


def _data_batches(args, device):
    from .data import ImageVideoDataset

    s, f = args.sample_size, args.video_sample_n_frames
    ds = ImageVideoDataset(args.train_data_meta, args.train_data_dir,
                           video_sample_n_frames=f, height=s, width=s,
                           seed=args.seed)
    i = 0
    while True:
        items = [ds[(i + j) % len(ds)] for j in range(args.train_batch_size)]
        i += args.train_batch_size
        pix = np.stack([it["pixel_values"] for it in items])  # B, C, T, H, W
        yield {"video": torch.from_numpy(pix * 2.0 - 1.0).to(device)}


def main(argv=None, device=None):
    """Parse `argv` (sys.argv[1:] by default), build the models on `device`
    (the card by default) and train; returns {"state", "aux", "daux"}, the
    last step's metrics."""
    args = parse_args(argv)
    device = resolve_device(device)
    vae, disc, lpips = build_models(args, device)
    cfg = VAETrainConfig(
        learning_rate=args.learning_rate,
        disc_learning_rate=args.disc_learning_rate, use_ema=args.use_ema,
        loss=VAELossConfig(disc_start=args.disc_start,
                           perceptual_weight=args.perceptual_weight,
                           kl_weight=args.kl_weight))
    state = create_vae_train_state(vae, disc, cfg)
    ae_step, disc_step = make_vae_train_steps(vae, disc, cfg,
                                              lpips_apply=lpips)
    if args.tiny_demo:
        batches = _random_batches(args, device)
    else:
        if not args.train_data_meta:
            raise SystemExit("pass --train_data_meta or --tiny_demo")
        batches = _data_batches(args, device)

    gen = torch.Generator(device=device).manual_seed(args.seed + 17)
    logger = MetricLogger(args.output_dir)
    aux = daux = None
    try:
        for step, batch in enumerate(batches):
            if step >= args.max_train_steps:
                break
            state, aux = ae_step(state, batch, generator=gen)
            state, daux = disc_step(state, batch, generator=gen)
            logged = logger.log(step, {**aux, **daux})
            print(f"step {step}: loss={logged['loss']:.4f} "
                  f"disc={logged['disc_loss']:.4f}", flush=True)
    finally:
        logger.close()
    print("done")
    return {"state": state, "aux": aux, "daux": daux}


if __name__ == "__main__":
    main()
