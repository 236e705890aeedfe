"""Image-to-video / video-to-video pipeline through an inpaint model
(V5.1-12B-InP, `PRESETS["v5.1-12b-inpaint"]`).

Parity: easyanimate_tpu/pipeline/inpaint.py (reference
pipeline_easyanimate_inpaint.py):
  - the regenerate-region of the video is filled with -1, optionally
    noise-augmented (masked pixels stay clean), VAE-encoded (mode) and
    scaled: the masked-video latents;
  - the mask is resized straight to the latent grid (first frame on its own
    for the cache_mag VAE) or, without resize_inpaint_mask_directly,
    VAE-encoded;
  - the transformer takes [mask, masked-video latents] as inpaint_latents,
    concatenated to the latents on the channel axis;
  - strength < 1 starts at step t_start = N - int(N * strength) from the
    video latents noised for the sampler (JAX :175-192): flow matching
    (1 - sigma0) video + sigma0 noise, Euler video + sigma0 noise, the
    alpha-space samplers ddim_add_noise at the integer t0;
  - without a video an inpaint model runs T2V on zero mask and latents;
  - V4's CLIP-image branch (JAX :163-173): the CLIP patch states and their
    mask (ones by default) ride in `cond`, zeros for the unconditional half
    under CFG, and the loop zeroes both until step (1 - clip_apply_ratio)
    * n (t2v.py's _denoise, JAX t2v.py:305-315).
The V1-V3 Transformer3D is refused by name (refuse_transformer3d): JAX's
pipeline reads resize_inpaint_mask_directly and add_noise_in_inpaint_model
from the transformer's config (JAX inpaint.py:95, :125, :139, :151), which
its Transformer3DConfig does not have, so JAX serves no V1-V3 inpaint.
"""
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.transformer3d_legacy import Transformer3D
from ..models.vae.magvit import gaussian_mode, vae_encode
from .schedulers import (EulerConfig, FlowMatchEulerConfig, ddim_add_noise,
                         init_noise_sigma, schedule_arrays)
from .t2v import Callback, EasyAnimatePipeline, _check_output_type


def refuse_transformer3d(transformer, pipeline: str, fields: str) -> None:
    """Raise NotImplementedError for the V1-V3 Transformer3D in `pipeline`,
    whose JAX counterpart reads `fields` from the transformer's config;
    JAX's Transformer3DConfig lacks them (an AttributeError there), so the
    port adds no V1-V3 inpaint or control that JAX does not serve."""
    if isinstance(transformer, Transformer3D):
        raise NotImplementedError(
            f"{pipeline} does not take the V1-V3 Transformer3D: the JAX "
            f"pipeline reads {fields} from its config, which "
            "Transformer3DConfig does not have (not carried over, ROADMAP "
            "§3); use EasyAnimatePipeline (T2V) or PixArtMagvitPipeline")


def resize_mask_to_latent(mask: torch.Tensor, latent_shape: Sequence[int],
                          first_frame_special: bool) -> torch.Tensor:
    """Trilinear resize (align_corners=False) of a pixel mask (B, 1, T, H, W)
    to the latent grid; with first_frame_special (the cache_mag VAE) frame 0
    maps to latent frame 0 alone and the rest to the other latent frames."""
    lt, lh, lw = latent_shape[2:]

    def resize(m, frames):
        return F.interpolate(m, size=(frames, lh, lw), mode="trilinear",
                             align_corners=False)

    if not first_frame_special:
        return resize(mask, lt)
    first = resize(mask[:, :, :1], 1)
    if lt == 1:
        return first
    return torch.cat([first, resize(mask[:, :, 1:], lt - 1)], dim=2)


def add_noise_to_reference_video(video: torch.Tensor,
                                 generator: Optional[torch.Generator] = None,
                                 ratio: Optional[float] = None,
                                 draws: Optional[Tuple[torch.Tensor,
                                                       torch.Tensor]] = None
                                 ) -> torch.Tensor:
    """video + sigma * N(0, 1) per sample, sigma = ratio or exp(N(-3, 0.5));
    masked pixels (exactly -1) stay clean. `draws` (the N(0, 1) draws: [B]
    for sigma, video's shape for the noise) are drawn from `generator`
    when not handed in."""
    b = video.shape[0]
    if ratio is None:
        draw = (torch.randn(b, generator=generator, device=video.device)
                if draws is None else draws[0])
        sigma = torch.exp(draw * 0.5 - 3.0)
    else:
        sigma = torch.full((b,), float(ratio), device=video.device)
    sigma = sigma.view(b, 1, 1, 1, 1).to(video.dtype)
    noise = (torch.randn(video.shape, generator=generator,
                         device=video.device, dtype=video.dtype)
             if draws is None else draws[1].to(video.dtype)) * sigma
    return video + torch.where(video == -1.0, 0.0, noise)


def v2v_init(sched, num_inference_steps: int, t_start: int,
             video_latents: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The first latents of a partial denoise from step t_start: the video
    latents noised as `sched`'s family does it (JAX inpaint.py:175-192)."""
    per_step, extras = schedule_arrays(sched, num_inference_steps, t_start)
    if isinstance(sched, FlowMatchEulerConfig):
        sigma0 = float(per_step[0, 1])
        return (1.0 - sigma0) * video_latents + sigma0 * noise
    if isinstance(sched, EulerConfig):  # EulerDiscreteScheduler.add_noise
        return video_latents + float(per_step[0, 1]) * noise
    return ddim_add_noise(video_latents, noise, int(per_step[0, 0]),
                          extras[0])


class EasyAnimateInpaintPipeline(EasyAnimatePipeline):
    """T2V / I2V / V2V through an inpaint-trained transformer."""

    def __init__(self, transformer, vae, *args, **kwargs):
        refuse_transformer3d(transformer, "EasyAnimateInpaintPipeline",
                             "resize_inpaint_mask_directly and "
                             "add_noise_in_inpaint_model")
        super().__init__(transformer, vae, *args, **kwargs)

    @torch.inference_mode()
    def __call__(self, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None, *,
                 video=None, mask_video=None, height: int = 384,
                 width: int = 672, video_length: int = 49,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 guidance_rescale: float = 0.0, strength: float = 1.0,
                 noise_aug_strength: float = 0.0563,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 prompt_embeds_t5: Optional[torch.Tensor] = None,
                 negative_prompt_embeds_t5: Optional[torch.Tensor] = None,
                 output_type: str = "np", decode: bool = True,
                 teacache_threshold: Optional[float] = None,
                 cfg_split: bool = False,
                 cfg_skip_ratio: Optional[float] = None,
                 clip_encoder_hidden_states: Optional[torch.Tensor] = None,
                 clip_attention_mask: Optional[torch.Tensor] = None,
                 clip_apply_ratio: float = 0.40,
                 callback: Callback = None):
        """video (B, 3, T, H, W) in [0, 1] and mask_video (B, 1, T, H, W),
        1 = generate (numpy or tensors, e.g. from
        utils.media.get_image_to_video_latent) -> video as
        EasyAnimatePipeline returns it. `latents` replaces the initial noise
        (unit variance); `generator` draws it and the noise augmentation
        otherwise. The serving knobs and V5's prompt_embeds_t5 are
        EasyAnimatePipeline's (JAX :84-85, :197-214); the CFG-doubled
        inpaint_latents are halved as the text is. V4's CLIP states
        (B, N, 1024) and mask (B, n_query) open at step (1 -
        clip_apply_ratio) * n."""
        _check_output_type(output_type)
        cfg, vcfg = self.transformer.cfg, self.vae.cfg
        dev = self.device
        shape = self.latent_shape(prompt_embeds.shape[0], video_length,
                                  height, width)
        has_inpaint_channels = cfg.in_channels != vcfg.latent_channels
        t_start = max(num_inference_steps
                      - int(num_inference_steps * strength), 0)
        is_strength_max = strength >= 1.0

        if latents is None:
            noise = torch.randn(shape, generator=generator, device=dev,
                                dtype=torch.float32)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        else:
            noise = latents.to(dev, torch.float32)

        def encode(x):
            moments = vae_encode(self.vae, x)
            return gaussian_mode(moments).float() * vcfg.scaling_factor

        if mask_video is not None:
            mask_video = torch.as_tensor(mask_video, device=dev,
                                         dtype=torch.float32)
        video_latents = None
        if video is not None:
            vid = (2.0 * torch.as_tensor(video, device=dev,
                                         dtype=torch.float32) - 1.0
                   ).to(vcfg.torch_dtype)
            masked_video = vid
            if mask_video is not None:
                # the regenerate region is -1, which the noise guard keys on
                keep = (mask_video < 0.5).to(vid.dtype)
                masked_video = vid * keep - (1.0 - keep)
            if noise_aug_strength and cfg.add_noise_in_inpaint_model:
                masked_video = add_noise_to_reference_video(
                    masked_video, generator, noise_aug_strength)
            masked_video_latents = encode(masked_video)
            if not is_strength_max:
                video_latents = encode(vid)
        elif has_inpaint_channels:
            masked_video_latents = torch.zeros(shape, device=dev)

        cond = self._t5_cond(prompt_embeds_t5, negative_prompt_embeds_t5,
                             guidance_scale)
        if has_inpaint_channels:
            if mask_video is None:
                n = 1 if cfg.resize_inpaint_mask_directly else vcfg.latent_channels
                mask_latents = torch.zeros((shape[0], n, *shape[2:]),
                                           device=dev)
            elif cfg.resize_inpaint_mask_directly:
                mask_latents = resize_mask_to_latent(
                    1.0 - mask_video, shape, vcfg.chunk_mode == "cache_mag"
                ) * vcfg.scaling_factor
            else:
                pix = (2.0 * (1.0 - mask_video) - 1.0).expand(
                    -1, 3, -1, -1, -1).to(vcfg.torch_dtype)
                mask_latents = encode(pix)
            inpaint = torch.cat([mask_latents, masked_video_latents],
                                dim=1).to(cfg.torch_dtype)
            if guidance_scale > 1.0:
                inpaint = torch.cat([inpaint, inpaint])
            cond["inpaint_latents"] = inpaint
        if clip_encoder_hidden_states is not None:
            clip = torch.as_tensor(clip_encoder_hidden_states, device=dev)
            cmask = (torch.ones((shape[0], getattr(cfg, "n_query", 16)),
                                device=dev)
                     if clip_attention_mask is None else
                     torch.as_tensor(clip_attention_mask, device=dev))
            if guidance_scale > 1.0:  # the unconditional half sees none
                clip = torch.cat([torch.zeros_like(clip), clip])
                cmask = torch.cat([torch.zeros_like(cmask), cmask])
            cond["clip_encoder_hidden_states"] = clip.to(cfg.torch_dtype)
            cond["clip_attention_mask"] = cmask

        if is_strength_max or video_latents is None:
            latents = noise * init_noise_sigma(self.scheduler,
                                               num_inference_steps)
        else:
            latents = v2v_init(self.scheduler, num_inference_steps, t_start,
                               video_latents, noise)
        latents = self._denoise(
            latents.to(cfg.torch_dtype),
            self._cfg_text(prompt_embeds, negative_prompt_embeds,
                           guidance_scale),
            height, width, num_inference_steps, guidance_scale,
            guidance_rescale, cond=cond, t_start=t_start, callback=callback,
            teacache_threshold=teacache_threshold, cfg_split=cfg_split,
            cfg_skip_ratio=cfg_skip_ratio, generator=generator,
            clip_apply_ratio=(clip_apply_ratio
                              if clip_encoder_hidden_states is not None
                              else None))
        return self._output(latents, output_type, decode)
