"""Generation controller and sliding-window long video.

Parity: easyanimate_tpu/ui/controller.py (reference easyanimate/ui/ui.py
EasyAnimateController):
  - generate() over T2V / I2V / V2V / image / long video (:368-680), one
    request at a time, the sampler reset to the model's own per request
    (`sampler` names any of the six, schedulers.make_scheduler); a control
    pipeline takes control_video / control_camera_video / ref_image
    through the keyword arguments, as JAX's generate does;
  - model, edition and LoRA swaps (:106-366);
  - sliding-window long video: `partial_video_length` frames a window,
    `overlap_video_length` frames blended linearly, the tail frames
    conditioning the next window (:485-546).
Deliberate differences from the JAX controller: a caller's `output_type`
or `decode` together with `fetch_yuv420` is a ValueError (JAX raises a
duplicate-keyword TypeError), generate is annotated with the YUV420Video
it can return, clearing a LoRA unmerges it at the scale it was merged
with (JAX unmerges at scale 1), and a checkpoint swap keeps the pipeline's
dtype and forgets the merged LoRA (JAX reloads in bf16 and would unmerge
the old LoRA from the new weights). The seed becomes a torch.Generator on
the pipeline's device; nothing falls back to the CPU.
"""
import dataclasses
import os
import threading
from typing import Callable, Optional, Union

import numpy as np
import torch

from ..pipeline import (EasyAnimateControlPipeline,
                        EasyAnimateInpaintPipeline, EasyAnimatePipeline)
from ..pipeline.schedulers import make_scheduler
from ..training.lora import LoRAConfig, load_lora, merge_lora, unmerge_lora
from ..utils.fp8 import FP8
from ..utils.media import (YUV420Video, _load_and_resize,
                           get_image_to_video_latent)
from ..utils.transfer import HostCopy


@dataclasses.dataclass
class EasyAnimateController:
    pipeline: EasyAnimatePipeline
    # prompts -> {"text": embeds} (loader.load_text_encoders), or
    # (embeds, mask), or embeds; None accepts no prompt strings
    encode_text: Optional[Callable] = None
    # reference controller flags (ui.py:69,99-100): TeaCache on every
    # generate() when enabled
    enable_teacache: bool = False
    teacache_threshold: float = 0.1
    lora_cfg: Optional[LoRAConfig] = None
    _lora: Optional[dict] = dataclasses.field(default=None, init=False)
    _lora_scale: Optional[float] = dataclasses.field(default=None, init=False)
    #: the model's own scheduler, captured before any per-request switch
    _default_scheduler: Optional[object] = dataclasses.field(
        default=None, init=False)
    #: generations and model swaps run one at a time: the server is
    #: threaded, but requests set pipeline.scheduler, swaps replace or
    #: change the weights, and all share one card (reentrant: an edition
    #: swap loads a checkpoint)
    _gen_lock: object = dataclasses.field(
        default_factory=threading.RLock, init=False)

    #: the server checks this before passing fetch_yuv420=True (a class
    #: attribute, not a field); controllers without it get the RGB path
    supports_yuv420_fetch = True

    # -- model management ---------------------------------------------------

    def update_diffusion_transformer(self, path: str):
        """Load another checkpoint directory into a pipeline of the same
        kind, dtype and device, keeping fp8 weight storage and the quantized
        block linears' mode, as JAX's (easyanimate_tpu/ui/controller.py:
        55-78): an fp8- or int4-served 12B does not come back in bf16
        (twice or four times the memory), nor W4A16 as W4A8, after a
        swap."""
        from ..loader import load_pipeline

        with self._gen_lock:
            fp8 = any(p.dtype == FP8
                      for p in self.pipeline.transformer.parameters())
            quant = self.pipeline.transformer.cfg.linear_quant
            kind = ("inpaint" if isinstance(self.pipeline,
                                            EasyAnimateInpaintPipeline)
                    else "control" if isinstance(self.pipeline,
                                                 EasyAnimateControlPipeline)
                    else "t2v")
            self.pipeline = load_pipeline(
                path, pipeline_type=kind,
                dtype=self.pipeline.transformer.cfg.dtype, fp8_weights=fp8,
                int8_linears=quant == "int8",
                int4_weights=quant in ("int4", "w4a8"),
                int4_compute="bf16" if quant == "int4" else "int8",
                device=self.pipeline.device)
            self._default_scheduler = None  # new pipeline, new default
            self._lora = self._lora_scale = None  # no LoRA in its weights

    #: edition name -> config yaml (reference ui.py update_edition table)
    EDITION_CONFIGS = {
        "v1": "config/easyanimate_video_v1_motion_module.yaml",
        "v2": "config/easyanimate_video_v2_magvit_motion_module.yaml",
        "v3": "config/easyanimate_video_v3_slicevae_motion_module.yaml",
        "v4": "config/easyanimate_video_v4_slicevae_multi_text_encoder.yaml",
        "v5": "config/easyanimate_video_v5_magvit_multi_text_encoder.yaml",
        "v5.1": "config/easyanimate_video_v5.1_magvit_qwen.yaml",
    }

    def update_edition(self, edition: str, model_path: Optional[str] = None):
        """Switch editions (reference ui.py:137-178): read the edition's
        yaml config and, given a checkpoint directory, load it. Returns the
        config dict so a front end can sync its widgets."""
        from ..utils.config import load_yaml_config

        key = edition.lower().replace("easyanimate", "").strip("-_ ")
        if key not in self.EDITION_CONFIGS:
            raise ValueError(f"unknown edition {edition!r}; one of "
                             f"{sorted(self.EDITION_CONFIGS)}")
        root = os.path.join(os.path.dirname(__file__), "..", "..")
        cfg = load_yaml_config(os.path.join(root, self.EDITION_CONFIGS[key]))
        with self._gen_lock:
            self.edition = key
            self.edition_config = cfg
            if model_path:
                self.update_diffusion_transformer(model_path)
        return cfg

    def update_lora(self, path: Optional[str], scale: float = 1.0):
        """Merge a LoRA into the live transformer's weights, or with no path
        clear it: a merged LoRA is unmerged first, at its own scale. A
        `.safetensors` path is a kohya (reference) LoRA file, anything else
        the port's save_lora files."""
        with self._gen_lock:
            model = self.pipeline.transformer
            if self._lora is not None:
                unmerge_lora(model, self._lora, self.lora_cfg,
                             self._lora_scale)
                self._lora = self._lora_scale = None
            if path:
                if path.endswith(".safetensors"):
                    from ..models.convert import load_lora_reference

                    lora, cfg = load_lora_reference(model, path,
                                                    self.pipeline.device)
                else:
                    lora, cfg = load_lora(path, self.pipeline.device)
                merge_lora(model, lora, cfg, scale=scale)
                self._lora, self.lora_cfg, self._lora_scale = lora, cfg, scale

    # -- generation -----------------------------------------------------------

    def _embeds(self, prompt: str, negative_prompt: str):
        """(positive, negative) prompt embeddings from encode_text."""
        if self.encode_text is None:
            raise ValueError("no text encoder attached; pass prompt embeds "
                             "to the pipeline directly")
        pos = self.encode_text([prompt])
        neg = self.encode_text([negative_prompt or ""])
        if isinstance(pos, dict):
            if pos.get("text_t5") is not None:
                raise NotImplementedError("a second (T5) text stream is not "
                                          "ported (ROADMAP queue 1 item 11)")
            return pos["text"], neg["text"]
        if isinstance(pos, tuple):  # (embeds, mask)
            return pos[0], neg[0]
        return pos, neg

    def generate(self, *args, **kwargs) -> Union[np.ndarray, YUV420Video]:
        """One generation at a time, and none during a model swap. Returns the
        video (1, 3, T, H, W) float in [0, 1] as a numpy array (what a
        caller's output_type makes of it), or YUV420Video planes with
        fetch_yuv420."""
        with self._gen_lock:
            return self._generate(*args, **kwargs)

    def _generate(
        self,
        prompt: str = "",
        negative_prompt: str = "",
        sample_steps: int = 25,
        width: int = 672,
        height: int = 384,
        video_length: int = 49,
        cfg_scale: float = 6.0,
        seed: int = 43,
        generation_method: str = "Video Generation",
        start_image: Optional[np.ndarray] = None,
        end_image: Optional[np.ndarray] = None,
        source_video: Optional[np.ndarray] = None,
        denoise_strength: float = 0.7,
        sampler: Optional[str] = None,
        fetch_yuv420: bool = False,
        **kw,
    ) -> Union[np.ndarray, YUV420Video]:
        if fetch_yuv420 and {"output_type", "decode"} & kw.keys():
            raise ValueError("fetch_yuv420 decodes the video to 4:2:0 planes "
                             "itself; drop output_type / decode, or "
                             "fetch_yuv420")
        if self._default_scheduler is None:
            self._default_scheduler = self.pipeline.scheduler
        # per request, from the model's default: a request without a
        # sampler must not inherit the previous request's (ui.py:472)
        self.pipeline.scheduler = self._default_scheduler
        if sampler:
            self.pipeline.scheduler = make_scheduler(
                sampler, base=self._default_scheduler)
        pos, neg = self._embeds(prompt, negative_prompt)
        if self.enable_teacache:
            kw.setdefault("teacache_threshold", self.teacache_threshold)
        generator = torch.Generator(device=self.pipeline.device).manual_seed(
            seed)
        if generation_method == "Image Generation":
            video_length = 1
        elif generation_method == "Long Video Generation":
            # video_length is the TOTAL length (reference ui.py:449,
            # 485-546); V2V does not take it there either (ui.py:487)
            if source_video is not None:
                raise ValueError(
                    "Video to Video does not support Long Video Generation")
            _need_inpaint(self.pipeline, "Long Video Generation")

            def frame(img):  # (H, W, 3) in [0, 1] -> (3, H, W)
                if img is None:
                    return None
                return _load_and_resize(img, (height, width)).transpose(
                    2, 0, 1)

            return generate_long_video(
                self.pipeline, pos, neg, total_length=video_length,
                partial_video_length=int(kw.pop("partial_video_length", 49)),
                overlap_video_length=int(kw.pop("overlap_video_length", 4)),
                height=height, width=width, start_image=frame(start_image),
                end_image=frame(end_image), generator=generator,
                num_inference_steps=sample_steps, guidance_scale=cfg_scale,
                **kw)
        kw.pop("partial_video_length", None)
        kw.pop("overlap_video_length", None)
        # the 4:2:0 fetch halves the device -> host bytes, lossless in the
        # 4:2:0 mp4; it needs even sizes (the /16 generation sizes are)
        use_yuv = fetch_yuv420 and height % 2 == 0 and width % 2 == 0
        kw.update(prompt_embeds=pos, negative_prompt_embeds=neg,
                  height=height, width=width, video_length=video_length,
                  num_inference_steps=sample_steps, guidance_scale=cfg_scale,
                  generator=generator)
        if start_image is not None or source_video is not None:
            _need_inpaint(self.pipeline, "image or video conditioning")
            if source_video is not None:
                video = torch.as_tensor(source_video)
                mask = torch.ones((1, 1, video.shape[2], height, width))
                strength = denoise_strength
            else:
                video, mask = get_image_to_video_latent(
                    start_image, end_image, video_length, (height, width))
                strength = 1.0
            kw.update(video=video, mask_video=mask, strength=strength)
        if not use_yuv:
            return self.pipeline(**kw)
        latents = self.pipeline(**kw, output_type="latent")
        return YUV420Video(*self.pipeline.decode_latents_yuv420(latents))


def _need_inpaint(pipeline, what: str) -> None:
    if not isinstance(pipeline, EasyAnimateInpaintPipeline):
        raise ValueError(f"{what} needs an inpaint pipeline")


def generate_long_video(pipeline: EasyAnimateInpaintPipeline, prompt_embeds,
                        negative_prompt_embeds, *, total_length: int,
                        partial_video_length: int = 49,
                        overlap_video_length: int = 4, height: int = 384,
                        width: int = 672,
                        start_image: Optional[np.ndarray] = None,
                        end_image: Optional[np.ndarray] = None,
                        generator: Optional[torch.Generator] = None,
                        **pipe_kw) -> np.ndarray:
    """Sliding-window long video with linear overlap blending (reference
    ui.py:485-546). start_image / end_image are (3, H, W) frames in [0, 1]
    conditioning the first / the final window. Returns (1, C, total, H, W)
    float in [0, 1]. One generator threads through the windows."""
    # the lengths can come from untrusted HTTP fields: a bad overlap would
    # loop forever (windows adding no frames) or break the blend
    norm_partial = (max(partial_video_length - 1, 1) // 4) * 4 + 1
    if total_length < 1:
        raise ValueError(f"total_length must be >= 1, got {total_length}")
    if not 0 <= overlap_video_length < norm_partial:
        raise ValueError(
            f"need 0 <= overlap_video_length < partial_video_length "
            f"(4k+1-normalized {norm_partial}), got {overlap_video_length}")
    if overlap_video_length and norm_partial < 2 * overlap_video_length:
        # every window but the last then spans >= 2 * overlap frames, so
        # its raw tail (the next window's condition) lies outside its
        # blended head, which the deferred host blend below relies on
        raise ValueError(
            f"need partial_video_length >= 2*overlap_video_length for "
            f"sliding-window generation (got {norm_partial} < "
            f"{2 * overlap_video_length})")
    dev = pipeline.device
    # each window's video stays on the card (output_type="device"); its
    # tail conditions the next window there, and its host copy
    # (HostCopy, a side stream) is waited for only after the next window
    # is queued, so the fetch and the blend run beside that denoise
    pipe_kw.setdefault("output_type", "device")
    n = overlap_video_length
    init_frames, last_tail, pending, host_chunks = 0, None, None, []
    while init_frames < total_length:
        remaining = total_length - init_frames
        if init_frames > 0:
            remaining += n  # regenerate the blend region
        this_len = (max(min(partial_video_length, remaining) - 1, 0)
                    // 4) * 4 + 1  # 4k+1 frames
        if init_frames > 0 and (this_len <= n or this_len <= 1):
            break  # a tail window would add no frames (< 4 left over)
        video = torch.zeros((1, 3, this_len, height, width), device=dev)
        mask = torch.ones((1, 1, this_len, height, width), device=dev)
        if last_tail is not None:
            k = last_tail.shape[2]  # under `overlap` after a short window
            video[:, :, :k] = last_tail
            mask[:, :, :k] = 0.0
        elif start_image is not None and init_frames == 0:
            # the first window only: with overlap 0 last_tail stays None,
            # and the start image must not condition every window
            video[0, :, 0] = torch.as_tensor(start_image, device=dev)
            mask[:, :, 0] = 0.0
        if end_image is not None:
            # the window that covers the final output frame
            idx = total_length - 1 - (init_frames - n if init_frames else 0)
            if 0 <= idx < this_len:
                video[0, :, idx] = torch.as_tensor(end_image, device=dev)
                mask[:, :, idx] = 0.0
        sample = pipeline(prompt_embeds, negative_prompt_embeds, video=video,
                          mask_video=mask, height=height, width=width,
                          video_length=this_len, generator=generator,
                          **pipe_kw)
        # blended output tails equal the raw chunk tail (the blend touches
        # only a chunk's first `overlap` frames)
        last_tail = sample[:, :, -n:] if n else None
        copy = HostCopy(sample)
        if pending is not None:
            host_chunks.append(pending.result())
        pending = copy
        init_frames += this_len if init_frames == 0 else this_len - n
    host_chunks.append(pending.result())

    out = host_chunks[0]
    w_new = np.linspace(0, 1, n).reshape(1, 1, n, 1, 1) if n else None
    for chunk in host_chunks[1:]:
        if n == 0:  # no overlap: the windows abut
            out = np.concatenate([out, chunk], axis=2)
            continue
        blended = out[:, :, -n:] * (1 - w_new) + chunk[:, :, :n] * w_new
        out = np.concatenate([out[:, :, :-n], blended, chunk[:, :, n:]],
                             axis=2)
    return out[:, :, :total_length]
