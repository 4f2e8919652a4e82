"""Data layer of the port: the processed-video datasets (batches built on
the device) and the ray, pose and audio helpers."""

from .provider import PoseAudioDataset, TalkingHeadDataset, load_audio_features
from .rays import (
    convert_poses,
    draw_pixels,
    euler_xyz_to_matrix,
    get_audio_features,
    get_bg_coords,
    get_rays,
    nerf_matrix_to_ngp,
    polygon_area,
    rays_from_pixels,
    smooth_camera_path,
)

__all__ = ["PoseAudioDataset", "TalkingHeadDataset", "load_audio_features",
           "convert_poses", "draw_pixels", "euler_xyz_to_matrix", "get_audio_features",
           "get_bg_coords", "get_rays", "nerf_matrix_to_ngp", "polygon_area",
           "rays_from_pixels", "smooth_camera_path"]
