"""The generation controller and the browser page the server serves."""
from .controller import EasyAnimateController, generate_long_video

__all__ = ["EasyAnimateController", "generate_long_video"]
