"""Streaming VO, trajectory alignment, reconstruction, polyp
localisation and keyframe pose refinement (port of ``colvo/vo``;
``refine_keyframe_poses`` is imported from ``colvo_torch.vo.refine``, as
the reference's is)."""

from colvo_torch.vo.align import align_poses, align_trajectory, umeyama
from colvo_torch.vo.driver import VOResult, chain_relative_poses, run_vo
from colvo_torch.vo.polyps import PolypDetection, PolypLocalization, localize_polyps
from colvo_torch.vo.recon import (
    PointCloud,
    backproject_depth_np,
    load_ply,
    save_ply,
    stitch_pointclouds,
    voxel_downsample,
)
from colvo_torch.vo.stream import StreamingVO

__all__ = [
    "VOResult",
    "run_vo",
    "chain_relative_poses",
    "StreamingVO",
    "umeyama",
    "align_trajectory",
    "align_poses",
    "PointCloud",
    "stitch_pointclouds",
    "voxel_downsample",
    "save_ply",
    "load_ply",
    "backproject_depth_np",
    "PolypDetection",
    "PolypLocalization",
    "localize_polyps",
]
