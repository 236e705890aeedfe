"""Host-side data helpers of the serving path (pure numpy)."""
from .camera import (CameraPose, plucker_embedding, plucker_from_file,
                     read_pose_file, relative_c2w)

__all__ = ["CameraPose", "plucker_embedding", "plucker_from_file",
           "read_pose_file", "relative_c2w"]
