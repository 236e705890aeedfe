"""MagViT VAE: encoder and decoder."""
from .magvit import (AutoencoderKLMagvit, MagvitVAEConfig, gaussian_kl,
                     gaussian_mode, gaussian_sample, latent_frame_count,
                     smooth_output, vae_decode, vae_decode_tiled, vae_encode,
                     vae_encode_tiled)

__all__ = ["AutoencoderKLMagvit", "MagvitVAEConfig", "gaussian_kl",
           "gaussian_mode", "gaussian_sample", "latent_frame_count",
           "smooth_output", "vae_decode", "vae_decode_tiled", "vae_encode",
           "vae_encode_tiled"]
