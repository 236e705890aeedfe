"""Control pipeline: pose / canny / depth video, camera trajectory and
reference-image control of the V5.1 Control models
(alibaba-pai/EasyAnimateV5.1-12b-zh-Control and -Control-Camera).

Parity: easyanimate_tpu/pipeline/control.py (reference
pipeline_easyanimate_control.py):
  - a control video is VAE-encoded (mode) and scaled: the control latents
    (:735-768);
  - a camera trajectory, the 6-channel Plücker video, is resized to the
    latent grid (frame 0 on its own) and scaled by 6, not encoded
    (:1063-1068);
  - without either the control latents are zeros;
  - a reference image is encoded into frame 0 of a zeros tensor and joins
    the control latents on the channel axis; zeros take its place when the
    model has the branch (add_ref_latent_in_control_model) and no image is
    given (:1094-1125);
  - under CFG both halves get the same control latents; the transformer
    takes them as `control_latents`, after the latents on the channel axis.
The loop and the decode are EasyAnimatePipeline's, with every sampler and
serving knob. The control pipeline takes no T5 stream, as JAX's does not
(easyanimate_tpu/pipeline/control.py:28-95 swallows prompt_embeds_t5 in
its **kw): on a V5 model it runs on the Bert stream alone, whatever the
controller hands it (a trap kept as it is, ROADMAP §3).
"""
from typing import Optional

import torch

from ..models.vae.magvit import gaussian_mode, vae_encode
from .inpaint import resize_mask_to_latent
from .schedulers import init_noise_sigma
from .t2v import Callback, EasyAnimatePipeline, _check_output_type

# the Plücker embedding's scale in the control latents (reference :1068)
CAMERA_SCALE = 6.0


class EasyAnimateControlPipeline(EasyAnimatePipeline):
    """Controlled T2V through a Control-trained transformer."""

    @torch.inference_mode()
    def __call__(self, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None, *,
                 control_video=None, control_camera_video=None,
                 ref_image=None, height: int = 384, width: int = 672,
                 video_length: int = 49, num_inference_steps: int = 50,
                 guidance_scale: float = 6.0, guidance_rescale: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 output_type: str = "np", decode: bool = True,
                 teacache_threshold: Optional[float] = None,
                 cfg_split: bool = False,
                 cfg_skip_ratio: Optional[float] = None,
                 callback: Callback = None,
                 prompt_embeds_t5=None, negative_prompt_embeds_t5=None):
        """control_video (B, 3, T, H, W) in [0, 1], or control_camera_video
        (B, 6, T, H, W) Plücker rays (data/camera.py's (T, H, W, 6),
        channels first), and ref_image (B, 3, 1, H, W) in [0, 1]: numpy
        arrays or tensors -> video as EasyAnimatePipeline returns it. The
        camera input wins over a control video, as in JAX. `latents`
        replaces the initial noise (unit variance); `generator` draws it
        otherwise. prompt_embeds_t5 / negative_prompt_embeds_t5 are taken
        and not used, as JAX's **kw takes them."""
        _check_output_type(output_type)
        cfg, vcfg = self.transformer.cfg, self.vae.cfg
        dev = self.device
        shape = self.latent_shape(prompt_embeds.shape[0], video_length,
                                  height, width)
        if latents is None:
            latents = torch.randn(shape, generator=generator, device=dev,
                                  dtype=torch.float32)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")

        def pixels(x):  # [0, 1] -> [-1, 1] in the VAE's dtype
            x = torch.as_tensor(x, device=dev, dtype=torch.float32)
            return (2.0 * x - 1.0).to(vcfg.torch_dtype)

        def encode(x):
            return (gaussian_mode(vae_encode(self.vae, pixels(x))).float()
                    * vcfg.scaling_factor)

        if control_camera_video is not None:
            camera = torch.as_tensor(control_camera_video, device=dev,
                                     dtype=torch.float32)
            control = resize_mask_to_latent(camera, shape, True) * CAMERA_SCALE
        elif control_video is not None:
            control = encode(control_video)
        else:
            control = torch.zeros(shape, device=dev)
        if ref_image is not None or cfg.add_ref_latent_in_control_model:
            ref = torch.zeros(shape, device=dev)
            if ref_image is not None:
                ref[:, :, :1] = encode(ref_image)
            control = torch.cat([control, ref], dim=1)
        control = control.to(cfg.torch_dtype)
        if guidance_scale > 1.0:
            control = torch.cat([control, control])

        latents = (latents.to(dev, torch.float32)
                   * init_noise_sigma(self.scheduler, num_inference_steps)
                   ).to(cfg.torch_dtype)
        latents = self._denoise(
            latents, self._cfg_text(prompt_embeds, negative_prompt_embeds,
                                    guidance_scale),
            height, width, num_inference_steps, guidance_scale,
            guidance_rescale, cond={"control_latents": control}, t_start=0,
            callback=callback, teacache_threshold=teacache_threshold,
            cfg_split=cfg_split, cfg_skip_ratio=cfg_skip_ratio,
            generator=generator)
        return self._output(latents, output_type, decode)
