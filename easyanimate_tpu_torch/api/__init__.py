"""The HTTP inference API: the server and its client."""
from .client import post_infer, update_diffusion_transformer
from .server import EasyAnimateAPIServer, infer_forward

__all__ = ["EasyAnimateAPIServer", "infer_forward", "post_infer",
           "update_diffusion_transformer"]
