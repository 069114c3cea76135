"""Dataset loading: the camera rig + body poses + image sequence triple.

Twin of ``aerial_mapper_tpu/pipeline/dataset.py``, host-side numpy only.
Mirrors the load preamble shared by every reference demo
(``main-dense-pcl.cc:50-63``, ``main-dsm.cc:59-74``,
``main-ortho-backward-grid.cc:82-97``): rig YAML, Standard-format poses,
images by prefix. Body poses are converted once to camera poses via the rig
extrinsics: T_G_C = T_G_B * T_C_B^-1 (ortho-backward-grid.cc:230-233),
host-side in float64 before any origin subtraction. A ``Dataset`` takes the
JAX ``Dataset``'s numpy fields as they are, with the port's ``CameraRig``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from aerial_mapper_tpu_torch.camera.rig import CameraRig, load_camera_rig
from aerial_mapper_tpu_torch.io.images import load_images_by_prefix
from aerial_mapper_tpu_torch.io.poses import (
    PoseFormat,
    _quat_from_matrix_np,
    _rot_matrix_np,
    load_poses,
    subtract_origin,
)


@dataclasses.dataclass
class Dataset:
    """Host-side dataset: float64 poses (wxyz quats), float32 images."""

    rig: CameraRig
    quats_G_B: np.ndarray  # [N, 4] body-to-world
    trans_G_B: np.ndarray  # [N, 3]
    images: List[np.ndarray]
    image_names: Optional[List[str]] = None

    @property
    def num_frames(self) -> int:
        return len(self.images)

    def camera_poses(self):
        """(quats_G_C [N,4], trans_G_C [N,3]) float64: T_G_C = T_G_B * T_B_C."""
        n = self.quats_G_B.shape[0]
        q_bc = self.rig.T_C_B_quats[0]
        R_bc = _rot_matrix_np(q_bc).T  # T_B_C rotation = T_C_B^-1
        t_bc = -R_bc @ self.rig.T_C_B_trans[0]
        quats_out = np.zeros((n, 4))
        trans_out = np.zeros((n, 3))
        for i in range(n):
            R_gb = _rot_matrix_np(self.quats_G_B[i])
            R_gc = R_gb @ R_bc
            quats_out[i] = _quat_from_matrix_np(R_gc)
            trans_out[i] = self.trans_G_B[i] + R_gb @ t_bc
        return quats_out, trans_out


def per_camera_prefix(prefix_images: str, cam_idx: int) -> str:
    """Per-camera image prefix: a ``{cam}`` placeholder in
    ``prefix_images`` (e.g. ``cam{cam}/image_``) is replaced by the camera
    index; a prefix without one is used as is."""
    if "{cam}" in prefix_images:
        return prefix_images.replace("{cam}", str(cam_idx))
    return prefix_images


def _load_poses_cut(data_directory, filename_poses, pose_format, origin,
                    max_frames):
    quats, trans, meta = load_poses(
        os.path.join(data_directory, filename_poses), pose_format
    )
    if origin is not None:
        trans = subtract_origin(trans, origin)
    n = quats.shape[0] if max_frames is None else min(max_frames, quats.shape[0])
    names = meta if isinstance(meta, list) else None
    return quats[:n], trans[:n], n, names


def load_multicam_datasets(
    data_directory: str,
    filename_camera_rig: str,
    filename_poses: str,
    prefix_images: str,
    pose_format: PoseFormat = PoseFormat.STANDARD,
    color: bool = False,
    origin=None,
    extension: str = ".jpg",
    max_frames: Optional[int] = None,
) -> List[Dataset]:
    """One Dataset per rig camera, sharing the body-pose trajectory.

    Dataset ``j`` has camera ``j`` promoted to the primary slot (so every
    single-camera pipeline consumes it unchanged) and its own image stream
    (``per_camera_prefix``).
    """
    rig = load_camera_rig(os.path.join(data_directory, filename_camera_rig))
    n_cams = len(rig.cameras)
    if n_cams > 1 and "{cam}" not in prefix_images:
        raise ValueError(
            "multi-camera loading needs a '{cam}' placeholder in "
            f"prefix_images to find each camera's stream (rig has {n_cams} "
            f"cameras, prefix_images={prefix_images!r})"
        )
    quats, trans, n, names = _load_poses_cut(
        data_directory, filename_poses, pose_format, origin, max_frames)
    datasets = []
    for j in range(n_cams):
        images = load_images_by_prefix(
            os.path.join(data_directory, per_camera_prefix(prefix_images, j)),
            n, color=color, extension=extension,
        )
        datasets.append(
            Dataset(rig=rig.select(j), quats_G_B=quats, trans_G_B=trans,
                    images=images, image_names=names)
        )
    return datasets


def load_dataset(
    data_directory: str,
    filename_camera_rig: str,
    filename_poses: str,
    prefix_images: str,
    pose_format: PoseFormat = PoseFormat.STANDARD,
    color: bool = False,
    origin=None,
    extension: str = ".jpg",
    max_frames: Optional[int] = None,
    camera_index: int = 0,
) -> Dataset:
    rig = load_camera_rig(os.path.join(data_directory, filename_camera_rig))
    if camera_index:
        # promote the chosen rig camera to primary (every pipeline consumes
        # slot 0, mirroring the reference's kFrameIdx = 0 call sites)
        rig = rig.select(camera_index)
    quats, trans, n, names = _load_poses_cut(
        data_directory, filename_poses, pose_format, origin, max_frames)
    images = load_images_by_prefix(
        os.path.join(data_directory,
                     per_camera_prefix(prefix_images, camera_index)),
        n, color=color, extension=extension,
    )
    return Dataset(rig=rig, quats_G_B=quats, trans_G_B=trans, images=images,
                   image_names=names)
