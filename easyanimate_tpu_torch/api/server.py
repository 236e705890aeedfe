"""HTTP inference API.

Parity: easyanimate_tpu/api/server.py (reference easyanimate/api/api.py):
POST /easyanimate/infer_forward (generate a video from a JSON payload),
/easyanimate/update_diffusion_transformer, /easyanimate/update_edition and
/easyanimate/update_lora, and the browser page at GET /; media travel as
base64. A standard-library ThreadingHTTPServer speaking the JSON protocol,
the work delegated to a controller (ui.controller.EasyAnimateController or
any object with its generate / update_* methods).

infer_forward is split into two pure helpers, composed in the same order:
request_kwargs (payload -> the controller's kwargs) and video_rgb (the
controller's result -> RGB), so a caller without an mp4 encoder can drive
everything before it. A deliberate difference from JAX: the flags
"yuv420_fetch", "enable_teacache" and "cfg_skip_ratio" are off for the
strings "false" and "0" too, not only for falsy JSON.
"""
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..utils.media import YUV420Video, yuv420_to_rgb


def encode_video_b64(video: np.ndarray, fps: int = 8,
                     color_transfer_post_process: bool = False) -> str:
    """(C, T, H, W) in [0, 1] -> base64 of its mp4 bytes."""
    import tempfile

    from ..utils.media import save_videos_grid

    with tempfile.NamedTemporaryFile(suffix=".mp4") as f:
        save_videos_grid(
            np.asarray(video)[None], f.name, fps=fps,
            color_transfer_post_process=color_transfer_post_process)
        f.seek(0)
        return base64.b64encode(f.read()).decode()


def decode_image_b64(data: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")
    return np.asarray(img, np.float32) / 255.0


def _opted_in(value) -> bool:
    """A flag that is on unless the client sends a falsy JSON value or the
    string "false" / "0"."""
    return bool(value) and str(value).strip().lower() not in ("false", "0")


def request_kwargs(controller, payload: dict) -> dict:
    """The JSON payload -> controller.generate's kwargs."""
    kwargs = dict(
        prompt=payload.get("prompt_textbox", payload.get("prompt", "")),
        negative_prompt=payload.get("negative_prompt_textbox", ""),
        sample_steps=int(payload.get("sample_step_slider", 25)),
        width=int(payload.get("width_slider", 672)),
        height=int(payload.get("height_slider", 384)),
        video_length=int(payload.get("length_slider", 49)),
        cfg_scale=float(payload.get("cfg_scale_slider", 6.0)),
        seed=int(payload.get("seed_textbox", 43)),
        generation_method=payload.get("generation_method", "Video Generation"),
    )
    if payload.get("partial_video_length"):
        # Long Video Generation sliders (reference ui.py:823-827)
        kwargs["partial_video_length"] = int(payload["partial_video_length"])
        kwargs["overlap_video_length"] = int(
            payload.get("overlap_video_length", 4))
    if payload.get("sampler_dropdown"):
        kwargs["sampler"] = payload["sampler_dropdown"]
    if payload.get("denoise_strength") is not None:
        kwargs["denoise_strength"] = float(payload["denoise_strength"])
    if _opted_in(payload.get("enable_teacache")):
        thr = payload.get("teacache_threshold")
        kwargs["teacache_threshold"] = float(thr) if thr is not None else 0.1
    if _opted_in(payload.get("cfg_skip_ratio")):
        # the last ratio of the steps cond-only (VideoX-Fun's knob)
        kwargs["cfg_skip_ratio"] = float(payload["cfg_skip_ratio"])
    if payload.get("start_image"):
        kwargs["start_image"] = decode_image_b64(payload["start_image"])
    if payload.get("end_image"):
        kwargs["end_image"] = decode_image_b64(payload["end_image"])
    if (_opted_in(payload.get("yuv420_fetch", True))
            and getattr(controller, "supports_yuv420_fetch", False)):
        # on by default where the controller has it: 4:2:0 planes off the
        # card (half the bytes), RGB rebuilt on the host for an mp4
        # encoder that is 4:2:0 anyway
        kwargs["fetch_yuv420"] = True
    return kwargs


def video_rgb(video) -> np.ndarray:
    """controller.generate's result -> (B, 3, T, H, W) float in [0, 1]."""
    if isinstance(video, YUV420Video):
        return yuv420_to_rgb(video.y, video.u, video.v
                             ).astype(np.float32) / 255.0
    return np.asarray(video)


def infer_forward(controller, payload: dict) -> dict:
    """The infer_forward route: payload -> {"message", "base64_encoding"}."""
    video = video_rgb(controller.generate(**request_kwargs(controller,
                                                           payload)))
    return {
        "message": "Success",
        "base64_encoding": encode_video_b64(
            video[0],
            # pin every frame's color statistics to frame 0 (reference
            # utils.py:49-62), for long videos that drift in tone
            color_transfer_post_process=bool(
                payload.get("color_transfer_post_process"))),
    }


class _Handler(BaseHTTPRequestHandler):
    controller = None

    def log_message(self, *a):
        pass

    def _send(self, code: int, body: bytes, content_type: str):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reply(self, code: int, obj: dict):
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        """The browser page (ui/web.py) at /."""
        if self.path in ("/", "/index.html"):
            from ..ui.web import INDEX_HTML

            self._send(200, INDEX_HTML.encode(), "text/html; charset=utf-8")
        else:
            self._reply(404, {"message": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            n = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/easyanimate/infer_forward":
                self._reply(200, infer_forward(self.controller, payload))
            elif self.path == "/easyanimate/update_diffusion_transformer":
                self.controller.update_diffusion_transformer(
                    payload["diffusion_transformer_path"])
                self._reply(200, {"message": "Success"})
            elif self.path == "/easyanimate/update_edition":
                self.controller.update_edition(payload["edition"])
                self._reply(200, {"message": "Success"})
            elif self.path == "/easyanimate/update_lora":
                self.controller.update_lora(
                    payload.get("lora_model_path"),
                    float(payload.get("lora_alpha_slider", 1.0)))
                self._reply(200, {"message": "Success"})
            else:
                self._reply(404, {"message": f"unknown path {self.path}"})
        except Exception as e:  # noqa: BLE001 - reported to the client
            self._reply(500, {"message": f"{type(e).__name__}: {e}"})


class EasyAnimateAPIServer:
    """`EasyAnimateAPIServer(controller).serve(port)`; threaded, the
    controller serializes the generations."""

    def __init__(self, controller):
        self._handler = type("BoundHandler", (_Handler,),
                             {"controller": controller})
        self._server: Optional[ThreadingHTTPServer] = None

    def serve(self, port: int = 7860, background: bool = False,
              host: str = "0.0.0.0"):
        self._server = ThreadingHTTPServer((host, port), self._handler)
        if background:
            t = threading.Thread(target=self._server.serve_forever,
                                 daemon=True)
            t.start()
            return t
        self._server.serve_forever()

    @property
    def port(self) -> int:
        """The bound port (serve(port=0) takes a free one)."""
        return self._server.server_address[1]

    def shutdown(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
