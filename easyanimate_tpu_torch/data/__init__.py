"""Host-side data: the camera rays of the serving path, and the training
input pipeline (manifest datasets, aspect buckets, masks, the threaded
loader). Pure numpy but for the loader's device copies."""
from .buckets import (ASPECT_RATIO_512, AspectRatioBatchSampler,
                      ResumableRandomSampler, get_closest_ratio,
                      make_aspect_buckets)
from .camera import (CameraPose, plucker_embedding, plucker_from_file,
                     read_pose_file, relative_c2w)
from .dataset import (ImageVideoControlDataset, ImageVideoDataset,
                      resize_center_crop, video_length_for_resolution)
from .masks import get_random_mask
from .prefetch import DataLoader, default_collate, device_prefetch, to_device

__all__ = ["ASPECT_RATIO_512", "AspectRatioBatchSampler", "CameraPose",
           "DataLoader", "ImageVideoControlDataset", "ImageVideoDataset",
           "ResumableRandomSampler", "default_collate", "device_prefetch",
           "get_closest_ratio", "get_random_mask", "make_aspect_buckets",
           "plucker_embedding", "plucker_from_file", "read_pose_file",
           "relative_c2w", "resize_center_crop", "to_device",
           "video_length_for_resolution"]
