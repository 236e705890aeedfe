"""Text-to-video pipeline: CFG-batched flow-matching denoise loop, then the
MagViT decode.

Parity: easyanimate_tpu/pipeline/t2v.py::EasyAnimatePipeline.__call__
(reference pipeline_easyanimate.py:769-1149): prompt embeds (+ negative) ->
CFG batch -> latents (frame remap) -> 3D RoPE from the 720x480 base grid ->
N Euler steps -> VAE decode. The loop is a Python loop over steps
(`_denoise`, which the inpaint pipeline shares), with the serving knobs of
JAX's `_denoise_fn_for` (:279-497):
  - TeaCache (`teacache_threshold`): block 0's modulated input gates the
    block stack; a skipped step reuses the previous step's residual. JAX
    branches on the device (lax.cond); here the gate's decision reaches the
    host with one `.item()` a step, its arithmetic stays on the device;
  - `cfg_split`: the uncond and cond halves run one after the other;
  - `cfg_skip_ratio`: the last round(ratio * n) steps run cond-only.
JAX's `scan_chunk` (a program-size knob with a bit-identical result) has
no counterpart. The decode variants: the 4:2:0 planes
(`decode_latents_yuv420`) and the chunked decode whose host copies run
beside the next chunk (`decode_latents_overlapped`). The loop steps with
the pipeline's `scheduler`, any of the six samplers (schedulers.py, JAX
:365-440): Euler's model input is scaled first, PNDM and DPM++ carry their
state across steps, Euler-A draws its step noise from the request's
generator. The transformer is the MMDiT (V5, V5.1), V4's HunyuanDiT
(models/hunyuan.py: its 2D RoPE from build_rope, its learned-sigma half
dropped from the prediction, no TeaCache polynomial, as in JAX) or the
V1-V3 Transformer3D (models/transformer3d_legacy.py: sinusoidal tables, so
build_rope's 2D tables go unused; learned sigma; no TeaCache polynomial); a
slice-mode VAE (V2's to V4's `slice_mag`) blends its chunk seams with
`smooth_output` by default (JAX :499-534); V1's 2D AutoencoderKL decodes
frame by frame, never tiled or smoothed, and the overlapped decode takes
decode_latents for it, as for any VAE without the cache protocol.
"""
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.mmdit import EasyAnimateTransformer3D
from ..models.vae.magvit import (AutoencoderKLMagvit, latent_frame_count,
                                 smooth_output, vae_decode, vae_decode_tiled)
from ..ops.rope import (get_2d_rotary_pos_embed, get_3d_rotary_pos_embed,
                        get_resize_crop_region_for_grid)
from ..parallel.context import check_serving_mesh, current_sp
from ..utils.transfer import HostCopy
from .schedulers import (FlowMatchEulerConfig, SamplerLoop, init_noise_sigma,
                         rescale_noise_cfg)

Callback = Optional[Callable[[int, torch.Tensor], None]]
OUTPUT_TYPES = ("np", "uint8", "latent", "device")

# TeaCache rel-L1 -> skip-score polynomial, highest degree first (reference
# transformer3d.py:1485-1491, the V5.1-12B calibration)
TEACACHE_COEFFICIENTS = (
    -10.47857366, 8.33844143, -0.78477557, 0.68798618, 0.0136149)


def get_teacache_coefficients(model_name: str):
    """Per-model TeaCache polynomials (reference transformer3d.py:124-137),
    matched on a lowercase substring of the model path; None for models
    without one."""
    name = model_name.lower()
    if "v5.1-7b" in name:
        return (1.07862322, -4.19362456, 3.06725828, 0.33161686, 0.02374758)
    if "v5.1-12b" in name:
        return TEACACHE_COEFFICIENTS
    return None


def teacache_gate(mod: torch.Tensor, prev_mod: torch.Tensor,
                  acc: torch.Tensor, idx: int, n_steps: int,
                  threshold: float, coefficients):
    """The TeaCache decision (reference transformer3d.py:1564-1584), in
    float32 on the tensors' device: rel = mean|mod - prev| / max(mean|prev|,
    1e-8) over the whole batch; acc + poly(rel) (np.polyval order);
    compute when that reaches `threshold`, and always at the first and last
    step. At a computed step the accumulator resets to 0 without keeping
    the polynomial. Under a sequence-parallel scope the tensors are the
    rank's token slices and the means run over all of them. Returns
    (should (0-d bool tensor), rel, acc_out)."""
    mod, prev = mod.float(), prev_mod.float()
    scope = current_sp()
    if scope is None:
        rel = (mod - prev).abs().mean() / prev.abs().mean().clamp_min(1e-8)
    else:  # token slices: the means over every sp rank's tokens
        sums = torch.stack([(mod - prev).abs().sum(), prev.abs().sum()])
        dist.all_reduce(sums, group=scope.group)
        sums /= mod.numel() * scope.size
        rel = sums[0] / sums[1].clamp_min(1e-8)
    poly = torch.zeros_like(rel)
    for c in torch.tensor(coefficients, dtype=torch.float32):
        poly = poly * rel + c
    acc_new = acc + poly
    should = (acc_new >= threshold) | (idx == 0 or idx == n_steps - 1)
    return should, rel, torch.where(should, 0.0, acc_new)


def _cfg_half(a, i: int, b: int):
    """Half i (0 = uncond, 1 = cond) of a CFG-batched tensor: one whose
    leading dim is exactly 2 * b is sliced, anything else (None, batch-b
    conditioning) passes through. The rule for the cfg_split halves and the
    cfg_skip cond-only tail alike."""
    if not torch.is_tensor(a) or a.dim() < 1 or a.shape[0] != 2 * b:
        return a
    return a[i * b:(i + 1) * b]


def build_rope(cfg, height: int, width: int, latent_frames: int,
               vae_scale: Optional[int] = None, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables (cos, sin) float32 for a (height, width, frames)
    generation (pipeline_easyanimate.py:998-1019), on `device` (the card by
    default): the MMDiT's 3D tables [T*h*w, head_dim] from the 720x480 base
    grid, or for V4's `2d_rope` (HunyuanConfig) single-frame tables
    [h*w, head_dim] from a 512x512 base, which the blocks tile over the
    frames (JAX t2v.py:117-122)."""
    s = (vae_scale or cfg.vae_scale_factor) * cfg.patch_size
    gh, gw = height // s, width // s
    if cfg.time_position_encoding_type == "3d_rope":
        crop = get_resize_crop_region_for_grid(
            (gh, gw), cfg.rope_base_width // s, cfg.rope_base_height // s)
        cos, sin = get_3d_rotary_pos_embed(cfg.attention_head_dim, crop,
                                           (gh, gw), latent_frames)
    else:
        base = 512 // s
        crop = get_resize_crop_region_for_grid((gh, gw), base, base)
        cos, sin = get_2d_rotary_pos_embed(cfg.attention_head_dim, crop,
                                           (gh, gw))
    device = resolve_device(device)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


class _TeaCache:
    """The TeaCache carry: the previous step's modulated input and block
    stack residual (token tensors of the CFG batch), the float32
    accumulator on the device, and the count of skipped steps."""

    def __init__(self, batch: int, tokens: int, dim: int, dtype, device):
        self.prev_mod = torch.zeros(batch, tokens, dim, dtype=dtype,
                                    device=device)
        self.prev_res = torch.zeros_like(self.prev_mod)
        self.acc = torch.zeros((), dtype=torch.float32, device=device)
        self.skips = 0

    def keep_cond_half(self, b: int):
        """For the cond-only tail of a cfg_skip run."""
        self.prev_mod = _cfg_half(self.prev_mod, 1, b)
        self.prev_res = _cfg_half(self.prev_res, 1, b)


class EasyAnimatePipeline:
    """T2V generation on `device`, by default the one that holds the
    transformer's parameters (the card for a model built with the
    defaults). Inside parallel.sequence_parallel(mesh) -- every sp rank
    calling with the same inputs -- the MMDiT's video tokens split over
    the ranks (models/mmdit.py::shard_tokens) and each rank returns the
    whole result; a mesh with dp > 1 raises (not ported)."""

    def __init__(self, transformer: EasyAnimateTransformer3D,
                 vae: AutoencoderKLMagvit, device=None,
                 scheduler=FlowMatchEulerConfig()):
        self.transformer = transformer
        self.vae = vae
        self.device = (next(transformer.parameters()).device if device is None
                       else torch.device(device))
        # any sampler config of schedulers.py (make_scheduler switches it)
        self.scheduler = scheduler
        # the loader sets this from the checkpoint's path
        # (get_teacache_coefficients); None turns TeaCache off, as for V4's
        # HunyuanDiT and the V1-V3 Transformer3D, which have no polynomial
        # (and no embed / backbone split to gate)
        self.teacache_coefficients = (
            TEACACHE_COEFFICIENTS
            if isinstance(transformer, EasyAnimateTransformer3D) else None)
        # steps the TeaCache gate skipped in the last run (None without it)
        self.last_teacache_skips: Optional[int] = None
        self._teacache_warned = False

    def latent_shape(self, batch: int, video_length: int, height: int,
                     width: int) -> Tuple[int, ...]:
        cfg = self.vae.cfg
        sf = cfg.spatial_compression
        return (batch, cfg.latent_channels,
                latent_frame_count(video_length, cfg), height // sf, width // sf)

    @torch.inference_mode()
    def __call__(self, prompt_embeds: torch.Tensor,
                 negative_prompt_embeds: Optional[torch.Tensor] = None, *,
                 height: int = 384, width: int = 672, video_length: int = 49,
                 num_inference_steps: int = 50, guidance_scale: float = 6.0,
                 guidance_rescale: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None,
                 prompt_embeds_t5: Optional[torch.Tensor] = None,
                 negative_prompt_embeds_t5: Optional[torch.Tensor] = None,
                 output_type: str = "np", decode: bool = True,
                 teacache_threshold: Optional[float] = None,
                 cfg_split: bool = False,
                 cfg_skip_ratio: Optional[float] = None,
                 callback: Callback = None):
        """prompt embeds (B, S, D) -> video (B, 3, T, H, W): a numpy array,
        float in [0, 1] ('np') or uint8 ('uint8'); the float video still on
        the device ('device'); or the final latents ('latent', or
        decode=False). V5's second stream, prompt_embeds_t5 (and its
        negative under CFG), rides beside the text (JAX :171-212). `latents`
        replaces the initial noise; `generator` draws it otherwise.
        `callback(step, latents)` runs after every step (PNDM: after each of
        its N + 1 evaluations). The serving knobs are the module
        docstring's."""
        _check_output_type(output_type)
        shape = self.latent_shape(prompt_embeds.shape[0], video_length,
                                  height, width)
        if latents is None:
            latents = torch.randn(shape, generator=generator,
                                  device=self.device, dtype=torch.float32)
        elif tuple(latents.shape) != shape:
            raise ValueError(f"latents {tuple(latents.shape)} != {shape}")
        latents = latents.to(self.device, torch.float32)
        latents = (latents * init_noise_sigma(self.scheduler,
                                              num_inference_steps)
                   ).to(self.transformer.cfg.torch_dtype)
        latents = self._denoise(
            latents, self._cfg_text(prompt_embeds, negative_prompt_embeds,
                                    guidance_scale),
            height, width, num_inference_steps, guidance_scale,
            guidance_rescale,
            cond=self._t5_cond(prompt_embeds_t5, negative_prompt_embeds_t5,
                               guidance_scale),
            t_start=0, callback=callback,
            teacache_threshold=teacache_threshold, cfg_split=cfg_split,
            cfg_skip_ratio=cfg_skip_ratio, generator=generator)
        return self._output(latents, output_type, decode)

    def _cfg_text(self, prompt_embeds, negative_prompt_embeds,
                  guidance_scale: float) -> torch.Tensor:
        """The text batch on the device: [negative; positive] under CFG."""
        if guidance_scale <= 1.0:
            return prompt_embeds.to(self.device)
        if negative_prompt_embeds is None:
            raise ValueError("CFG (guidance_scale > 1) needs negative embeds")
        return torch.cat([negative_prompt_embeds, prompt_embeds]).to(self.device)

    def _t5_cond(self, prompt_embeds_t5, negative_prompt_embeds_t5,
                 guidance_scale: float) -> Dict[str, torch.Tensor]:
        """V5's second text stream as a transformer keyword, CFG-batched as
        the text is; it then follows the text through cfg_split's halves,
        cfg_skip's cond-only tail and TeaCache's embed, as every `cond`
        entry does. Empty without it."""
        if prompt_embeds_t5 is None:
            return {}
        return {"encoder_hidden_states_t5": self._cfg_text(
            prompt_embeds_t5, negative_prompt_embeds_t5, guidance_scale)}

    def _teacache_on(self, threshold: Optional[float]) -> Optional[float]:
        """The threshold, or None when the model has no calibrated
        polynomial (the reference refuses TeaCache then, ui.py:477-478);
        said once per pipeline, not per request."""
        if threshold is not None and self.teacache_coefficients is None:
            if not self._teacache_warned:
                print("TeaCache disabled: no calibrated coefficients for "
                      "this model (get_teacache_coefficients returned None)")
                self._teacache_warned = True
            return None
        return threshold

    def _denoise(self, latents: torch.Tensor, txt: torch.Tensor, height: int,
                 width: int, num_inference_steps: int, guidance_scale: float,
                 guidance_rescale: float, cond: Dict[str, torch.Tensor],
                 t_start: int = 0, callback: Callback = None,
                 teacache_threshold: Optional[float] = None,
                 cfg_split: bool = False,
                 cfg_skip_ratio: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 clip_apply_ratio: Optional[float] = None) -> torch.Tensor:
        """The sampler's loop from step t_start on (JAX _denoise_fn): each
        step runs the transformer on the CFG batch with `cond` (keyword
        arguments of the transformer, already CFG-batched), combines the
        halves and steps the latents with self.scheduler. `generator` draws
        Euler-A's step noise. With clip_apply_ratio, cond's CLIP states and
        mask are zeros before step (1 - ratio) * n (V4's I2V, JAX
        :305-315). callback(i, latents) after each."""
        check_serving_mesh()
        do_cfg = guidance_scale > 1.0
        latent_channels = self.vae.cfg.latent_channels
        rope = build_rope(self.transformer.cfg, height, width,
                          latents.shape[2],
                          vae_scale=self.vae.cfg.spatial_compression,
                          device=self.device)
        sampler = SamplerLoop(self.scheduler, num_inference_steps, t_start,
                              generator)
        n, b = len(sampler), latents.shape[0]
        threshold = self._teacache_on(teacache_threshold)
        tea = None
        if threshold is not None:
            p = self.transformer.cfg.patch_size
            # under a sequence-parallel scope the carry holds the rank's
            # token slice (JAX t2v.py:447-452)
            scope = current_sp()
            tea = _TeaCache(b * (2 if do_cfg else 1),
                            latents.shape[2] * (latents.shape[3] // p)
                            * (latents.shape[4] // p)
                            // (1 if scope is None else scope.size),
                            self.transformer.cfg.inner_dim, latents.dtype,
                            self.device)
        # cfg_skip: the last round(ratio * n) steps run cond-only (the
        # low-noise tail, VideoX-Fun's cfg_skip_ratio)
        m = n
        if do_cfg and cfg_skip_ratio:
            m = n - min(n, max(0, int(round(cfg_skip_ratio * n))))
        # the CLIP gate's first open step, compared in float32 as JAX's
        # step column is
        clip_open = (None if clip_apply_ratio is None
                     else float(np.float32((1.0 - clip_apply_ratio) * n)))
        for i in range(n):
            t, lat_model = sampler.timestep(i), sampler.model_input(i, latents)
            use_cfg = do_cfg and i < m
            if do_cfg and i == m:  # the positive halves from here on
                txt = _cfg_half(txt, 1, b)
                cond = {k: _cfg_half(v, 1, b) for k, v in cond.items()}
                if tea is not None:
                    tea.keep_cond_half(b)
            step_cond = cond
            if (clip_open is not None and i < clip_open
                    and "clip_encoder_hidden_states" in cond):
                step_cond = dict(cond, **{
                    k: torch.zeros_like(cond[k])
                    for k in ("clip_encoder_hidden_states",
                              "clip_attention_mask")})
            if tea is not None:
                pred = self._teacache_forward(lat_model, t, txt, rope,
                                              step_cond, use_cfg, tea, i, n,
                                              threshold)
            elif use_cfg and cfg_split:
                # uncond and cond halves one after the other: the same
                # math at about half the activation peak
                t_vec = torch.full((b,), t, dtype=torch.float32,
                                   device=self.device)
                pred = torch.cat([self.transformer(
                    lat_model, t_vec, _cfg_half(txt, h, b), rope,
                    **{k: _cfg_half(v, h, b) for k, v in step_cond.items()})
                    for h in (0, 1)])
            else:
                lat_in = (torch.cat([lat_model, lat_model]) if use_cfg
                          else lat_model)
                t_vec = torch.full((lat_in.shape[0],), t,
                                   dtype=torch.float32, device=self.device)
                pred = self.transformer(lat_in, t_vec, txt, rope, **step_cond)
            pred = pred[:, :latent_channels]  # drop a learned-sigma half
            if use_cfg:
                uncond, text = pred.chunk(2)
                pred = uncond + guidance_scale * (text - uncond)
                if guidance_rescale > 0:
                    pred = rescale_noise_cfg(pred, text, guidance_rescale)
            latents = sampler.step(i, latents, pred)
            if callback is not None:
                callback(i, latents)
        self.last_teacache_skips = None if tea is None else tea.skips
        return latents

    def _teacache_forward(self, latents, t: float, txt, rope, cond,
                          use_cfg: bool, tea: _TeaCache, idx: int,
                          n_steps: int, threshold: float) -> torch.Tensor:
        """One TeaCache-gated transformer eval (JAX t2v.py:339-375): embed,
        gate on the modulated input, then the block stack or the cached
        residual, then the head."""
        model = self.transformer
        lat_in = torch.cat([latents, latents]) if use_cfg else latents
        _, _, t_, hh, ww = lat_in.shape
        t_vec = torch.full((lat_in.shape[0],), t, dtype=torch.float32,
                           device=self.device)
        vid0, txt_tok, temb = model.embed(lat_in, t_vec, txt, **cond)
        vid0, rope = model.shard_tokens(vid0, rope)
        mod = model.modulated_input(vid0, txt_tok, temb)
        should, _, tea.acc = teacache_gate(mod, tea.prev_mod, tea.acc, idx,
                                           n_steps, threshold,
                                           self.teacache_coefficients)
        tea.prev_mod = mod
        if should.item():  # the step's one host sync
            p = model.cfg.patch_size
            vid = model.backbone(vid0, txt_tok, temb, rope,
                                 grid_size=(t_, hh // p, ww // p))
            tea.prev_res = vid - vid0
        else:
            vid = vid0 + tea.prev_res
            tea.skips += 1
        return model.head(vid, t_, hh, ww)

    def _output(self, latents: torch.Tensor, output_type: str,
                decode: bool = True):
        if output_type == "latent" or not decode:
            return latents
        if output_type == "device":
            return self.decode_latents(latents, as_numpy=False)
        return self.decode_latents(latents, to_uint8=output_type == "uint8")

    def smooth_default(self) -> bool:
        """The reference blends chunk seams only for the slice chunk modes
        (pipeline_easyanimate.py:729-731): on for `slice_mag`; `cache_mag`
        carries causal caches across chunks and has no seams."""
        return self.vae.cfg.chunk_mode == "slice_mag"

    def _decode_video(self, latents: torch.Tensor,
                      smooth: Optional[bool]) -> torch.Tensor:
        """latents -> float video (B, C, T, H, W) in [0, 1] on the device.
        Spatial tiling engages when the latent is wider or taller than
        tile_sample_min_size pixels. `smooth` (None: smooth_default) runs
        smooth_output between two clamps to [-1, 1] when the decode is not
        tiled and there is more than one latent frame (JAX :515-556)."""
        cfg = self.vae.cfg
        tiled = max(latents.shape[-2:]) > (cfg.tile_sample_min_size
                                           // cfg.spatial_compression)
        if smooth is None:
            smooth = self.smooth_default()
        lat = (latents.float() / cfg.scaling_factor).to(cfg.torch_dtype)
        video = (vae_decode_tiled if tiled else vae_decode)(self.vae, lat)
        if smooth and not tiled and latents.shape[2] > 1:
            video = smooth_output(self.vae, video.clamp(-1.0, 1.0))
            video = video.clamp(-1.0, 1.0)
        return (video.float() / 2 + 0.5).clamp(0.0, 1.0)

    @torch.inference_mode()
    def decode_latents(self, latents: torch.Tensor,
                       smooth: Optional[bool] = None, to_uint8: bool = False,
                       as_numpy: bool = True):
        """latents -> video (B, C, T, H, W): float in [0, 1], or uint8
        rounded on the device; a numpy array, or with as_numpy=False the
        tensor still on the device (its host copy can then overlap later
        work, as generate_long_video does)."""
        out = self._decode_video(latents, smooth)
        if to_uint8:
            out = _to_uint8(out)
        return out.cpu().numpy() if as_numpy else out

    @torch.inference_mode()
    def decode_latents_yuv420(self, latents: torch.Tensor,
                              smooth: Optional[bool] = None,
                              as_numpy: bool = True):
        """latents -> (y, u, v) uint8 planes: y (B, T, H, W), u and v
        (B, T, H/2, W/2), full-range BT.601 in float32 with the chroma 2x2
        box-averaged before quantizing, rounded on the device: 1.5 bytes a
        pixel to fetch instead of 3, no loss in the 4:2:0 mp4 the server
        writes. utils.media.yuv420_to_rgb reconstructs RGB on the host."""
        planes = rgb_to_yuv420(self._decode_video(latents, smooth))
        return tuple(p.cpu().numpy() for p in planes) if as_numpy else planes

    @torch.inference_mode()
    def decode_latents_overlapped(self, latents: torch.Tensor,
                                  to_uint8: bool = True) -> np.ndarray:
        """The untiled `cache_mag` decode chunk by chunk, each chunk's host
        copy started as soon as it is queued (utils.transfer.HostCopy), so
        it runs beside the later chunks' decode. Equal to the untiled
        decode (vae_decode) with the same decode_chunk_frames: the causal
        cache threads the exact conv state. Untiled: at the published sizes
        a chunk's activations fit beside the resident transformer. Another
        chunk mode (or one latent frame) takes decode_latents, as in JAX."""
        if self.vae.cfg.chunk_mode != "cache_mag" or latents.shape[2] == 1:
            return self.decode_latents(latents, to_uint8=to_uint8)
        cfg = self.vae.cfg
        chunk = cfg.decode_chunk_frames or cfg.mini_batch_decoder
        lat = (latents.float() / cfg.scaling_factor).to(cfg.torch_dtype)
        bounds = [(0, 1)] + [(i, i + chunk)
                             for i in range(1, lat.shape[2], chunk)]
        copies, cache = [], None
        for start, end in bounds:
            video, cache = self.vae.decode_chunk(lat[:, :, start:end], cache)
            out = (video.float() / 2 + 0.5).clamp(0.0, 1.0)
            copies.append(HostCopy(_to_uint8(out) if to_uint8 else out))
        return np.concatenate([c.result() for c in copies], axis=2)


def _to_uint8(video: torch.Tensor) -> torch.Tensor:
    return torch.round(video * 255.0).to(torch.uint8)


def rgb_to_yuv420(out: torch.Tensor):
    """(B, 3, T, H, W) float RGB in [0, 1] -> uint8 (y, u, v), full-range
    BT.601, chroma 2x2 box-averaged in float before quantizing (JAX
    t2v.py:560-575)."""
    r, g, b = out[:, 0], out[:, 1], out[:, 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 0.5
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 0.5

    def sub(p):
        return 0.25 * (p[..., 0::2, 0::2] + p[..., 1::2, 0::2]
                       + p[..., 0::2, 1::2] + p[..., 1::2, 1::2])

    def to8(p):
        return _to_uint8(p.clamp(0.0, 1.0))

    return to8(y), to8(sub(u)), to8(sub(v))


def _check_output_type(output_type: str) -> None:
    if output_type not in OUTPUT_TYPES:
        raise ValueError(f"unknown output_type {output_type!r}")
