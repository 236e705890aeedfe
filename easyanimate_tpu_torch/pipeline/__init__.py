"""Text-to-video, inpaint (image/video-to-video) and control pipelines and
their samplers."""
from .control import EasyAnimateControlPipeline
from .inpaint import EasyAnimateInpaintPipeline
from .pixart import PixArtMagvitPipeline
from .schedulers import (DDIMConfig, DPMSolverConfig, EulerAncestralConfig,
                         EulerConfig, FlowMatchEulerConfig, PNDMConfig,
                         make_scheduler)
from .t2v import EasyAnimatePipeline, build_rope

__all__ = ["DDIMConfig", "DPMSolverConfig", "EasyAnimateControlPipeline",
           "EasyAnimateInpaintPipeline", "EasyAnimatePipeline",
           "EulerAncestralConfig", "EulerConfig", "FlowMatchEulerConfig",
           "PNDMConfig", "PixArtMagvitPipeline", "build_rope",
           "make_scheduler"]
