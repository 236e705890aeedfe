"""PixArt-alpha text-to-image over a MagViT VAE.

Parity: easyanimate_tpu/pipeline/pixart.py (reference
pipeline_pixart_magvit.py:214-980, PixArtAlphaMagvitPipeline): the V1
image-pretrain path. A PixArt Transformer2D (models/transformer3d_legacy.py)
denoises single-frame latents that the video VAE decodes; everything is the
video pipeline's with video_length=1, and the output drops the frame axis.
"""
from .t2v import EasyAnimatePipeline


class PixArtMagvitPipeline(EasyAnimatePipeline):
    """T2I generation: (B, C, H, W) images (the output types of
    EasyAnimatePipeline, the frame axis dropped), or the latents."""

    def __call__(self, prompt_embeds, negative_prompt_embeds=None, *,
                 height: int = 512, width: int = 512, **kw):
        kw.pop("video_length", None)
        out = super().__call__(prompt_embeds, negative_prompt_embeds,
                               height=height, width=width, video_length=1,
                               **kw)
        if kw.get("output_type") == "latent" or not kw.get("decode", True):
            return out
        return out[:, :, 0]
