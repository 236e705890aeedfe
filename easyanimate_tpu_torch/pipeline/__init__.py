"""Text-to-video and inpaint (image/video-to-video) pipelines and their
sampler."""
from .inpaint import EasyAnimateInpaintPipeline
from .schedulers import FlowMatchEulerConfig
from .t2v import EasyAnimatePipeline, build_rope

__all__ = ["EasyAnimateInpaintPipeline", "EasyAnimatePipeline",
           "FlowMatchEulerConfig", "build_rope"]
