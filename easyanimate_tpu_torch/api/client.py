"""HTTP client for the inference API (reference api/post_infer.py):
builds the JSON payload, posts it to /easyanimate/infer_forward and writes
the base64 mp4. Standard library only.

A copy of easyanimate_tpu/api/client.py.
"""
import base64
import json
import urllib.request
from typing import Optional


def _post(url: str, route: str, payload: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url.rstrip("/") + route, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_infer(
    url: str = "http://127.0.0.1:7860",
    prompt: str = "",
    negative_prompt: str = "",
    generation_method: str = "Video Generation",
    length: int = 49,
    width: int = 672,
    height: int = 384,
    cfg_scale: float = 6.0,
    steps: int = 25,
    seed: int = 43,
    start_image_path: Optional[str] = None,
    end_image_path: Optional[str] = None,
    save_path: Optional[str] = None,
    timeout: float = 3600.0,
) -> dict:
    payload = {
        "prompt_textbox": prompt,
        "negative_prompt_textbox": negative_prompt,
        "generation_method": generation_method,
        "length_slider": length,
        "width_slider": width,
        "height_slider": height,
        "cfg_scale_slider": cfg_scale,
        "sample_step_slider": steps,
        "seed_textbox": seed,
    }
    for key, path in (("start_image", start_image_path),
                      ("end_image", end_image_path)):
        if path:
            with open(path, "rb") as f:
                payload[key] = base64.b64encode(f.read()).decode()
    out = _post(url, "/easyanimate/infer_forward", payload, timeout)
    if save_path and out.get("base64_encoding"):
        with open(save_path, "wb") as f:
            f.write(base64.b64decode(out["base64_encoding"]))
    return out


def update_diffusion_transformer(url: str, path: str) -> dict:
    return _post(url, "/easyanimate/update_diffusion_transformer",
                 {"diffusion_transformer_path": path}, 600)
