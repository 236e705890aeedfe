"""The video VAEs: the MagViT, and V1's 2D AutoencoderKL run frame by
frame."""
from .kl2d import AutoencoderKL, KL2DConfig
from .magvit import (AutoencoderKLMagvit, MagvitVAEConfig, gaussian_kl,
                     gaussian_mode, gaussian_sample, latent_frame_count,
                     smooth_output, vae_decode, vae_decode_tiled, vae_encode,
                     vae_encode_tiled)

__all__ = ["AutoencoderKL", "AutoencoderKLMagvit", "KL2DConfig",
           "MagvitVAEConfig", "gaussian_kl", "gaussian_mode", "gaussian_sample", "latent_frame_count",
           "smooth_output", "vae_decode", "vae_decode_tiled", "vae_encode",
           "vae_encode_tiled"]
