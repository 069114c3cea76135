"""Camera rig loading: aslam-style ncamera YAML + T_B_C extrinsics.

Twin of ``aerial_mapper_tpu/camera/rig.py``. Replaces
``aslam::NCamera::deserializeFromFile`` (invoked from
``aerial_mapper_io/src/aerial-mapper-io.cc:251-261``): the same YAML schema
(``cameras: [{camera: {intrinsics, distortion, ...}, T_B_C: ...}]``) parsed
into plain :class:`Camera` records and host float64 extrinsics. PyYAML is
imported only by the functions that read or write a file, so the module
imports without it. Distorted cameras load; the port's ortho refuses them
(``NotImplementedError``) until the distorted-camera path is ported. The
JAX rig's ``T_C_B()`` / ``T_B_C()`` (which return a JAX ``Pose``) are not
here: nothing on the port's paths calls them.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from aerial_mapper_tpu_torch.camera.models import (
    DIST_EQUIDISTANT,
    DIST_NONE,
    DIST_RADTAN,
    Camera,
)
from aerial_mapper_tpu_torch.io.poses import (
    _quat_from_matrix_np,
    _rot_matrix_np,
)

_DIST_ALIASES = {
    "none": DIST_NONE,
    "no-distortion": DIST_NONE,
    "null": DIST_NONE,
    "radial-tangential": DIST_RADTAN,
    "radtan": DIST_RADTAN,
    "plumb_bob": DIST_RADTAN,
    "equidistant": DIST_EQUIDISTANT,
    "fisheye": DIST_EQUIDISTANT,
}


@dataclasses.dataclass(frozen=True)
class CameraRig:
    """An n-camera rig: cameras + T_C_B (camera-from-body) extrinsics.

    ``T_C_B`` follows the reference's ``ncameras_->get_T_C_B(idx)``
    convention (``ortho-backward-grid.cc:230-233``: T_G_C = T_G_B * T_C_B^-1).
    Stored host-side as float64 numpy (q wxyz, t).
    """

    cameras: tuple
    T_C_B_quats: np.ndarray  # [N, 4] wxyz
    T_C_B_trans: np.ndarray  # [N, 3]

    @property
    def camera(self) -> Camera:
        return self.cameras[0]

    def select(self, idx: int) -> "CameraRig":
        """A rig with camera ``idx`` promoted to primary (slot 0): every
        pipeline consumes slot 0, as the reference demos do
        (``ncameras_->getCamera(kFrameIdx)``, kFrameIdx = 0,
        stereo.cpp:37-40)."""
        n = len(self.cameras)
        if not 0 <= idx < n:
            raise ValueError(f"camera index {idx} out of range ({n} cameras)")
        if idx == 0:
            return self
        order = [idx] + [i for i in range(n) if i != idx]
        return CameraRig(
            cameras=tuple(self.cameras[i] for i in order),
            T_C_B_quats=self.T_C_B_quats[order],
            T_C_B_trans=self.T_C_B_trans[order],
        )


def _mat_from_yaml(node) -> np.ndarray:
    rows, cols = int(node["rows"]), int(node["cols"])
    return np.asarray(node["data"], dtype=np.float64).reshape(rows, cols)


def _camera_from_yaml(cam_node) -> Camera:
    intr = _mat_from_yaml(cam_node["intrinsics"]).ravel()
    fx, fy, cx, cy = (float(x) for x in intr[:4])
    width = int(cam_node["image_width"])
    height = int(cam_node["image_height"])
    dist_kind = DIST_NONE
    dist_params = (0.0, 0.0, 0.0, 0.0)
    dist_node = cam_node.get("distortion")
    if dist_node:
        kind = _DIST_ALIASES.get(str(dist_node.get("type", "none")).lower())
        if kind is None:
            raise ValueError(f"Unsupported distortion type: {dist_node['type']}")
        if kind != DIST_NONE:
            params = _mat_from_yaml(dist_node["parameters"]).ravel()
            params = tuple(float(p) for p in params)
            if len(params) > 4 and any(p != 0.0 for p in params[4:]):
                # plumb_bob's 5th parameter (k3): the radtan model is
                # 4-parameter (like aslam's RadTanDistortion) — refuse to
                # silently drop a nonzero k3 and project with the wrong lens
                raise ValueError(
                    f"Unsupported distortion parameters beyond 4 "
                    f"(k3={params[4]} != 0); recalibrate with the "
                    "4-parameter radial-tangential model"
                )
            params = (params + (0.0,) * 4)[:4]
            if any(p != 0.0 for p in params):
                dist_kind, dist_params = kind, params
    return Camera(
        fx=fx, fy=fy, cx=cx, cy=cy, width=width, height=height,
        dist_kind=dist_kind, dist_params=dist_params,
    )


def load_camera_rig(filename: str) -> CameraRig:
    """Load an aslam ncamera YAML file into a CameraRig."""
    import yaml

    with open(filename, "r") as f:
        doc = yaml.safe_load(f)
    # aslam serializes either {cameras: [...]} or {ncameras: {cameras: [...]}}.
    if "ncameras" in doc:
        doc = doc["ncameras"]
    cameras: List[Camera] = []
    quats, trans = [], []
    for entry in doc["cameras"]:
        cam_node = entry["camera"] if "camera" in entry else entry
        cameras.append(_camera_from_yaml(cam_node))
        if "T_B_C" in entry:
            T = _mat_from_yaml(entry["T_B_C"])
            # invert host-side: T_C_B = T_B_C^-1
            R = T[:3, :3].T
            t = -R @ T[:3, 3]
        elif "T_C_B" in entry:
            T = _mat_from_yaml(entry["T_C_B"])
            R, t = T[:3, :3], T[:3, 3]
        else:
            R, t = np.eye(3), np.zeros(3)
        quats.append(_quat_from_matrix_np(R))
        trans.append(t)
    return CameraRig(
        cameras=tuple(cameras),
        T_C_B_quats=np.asarray(quats, dtype=np.float64),
        T_C_B_trans=np.asarray(trans, dtype=np.float64),
    )


def save_camera_rig(rig: CameraRig, filename: str) -> None:
    """Serialize a rig back to the aslam-compatible YAML schema."""
    import yaml

    entries = []
    for i, cam in enumerate(rig.cameras):
        T_C_B = np.eye(4)
        T_C_B[:3, :3] = _rot_matrix_np(rig.T_C_B_quats[i])
        T_C_B[:3, 3] = rig.T_C_B_trans[i]
        cam_node = {
            "label": f"cam{i}",
            "image_width": cam.width,
            "image_height": cam.height,
            "type": "pinhole",
            "intrinsics": {
                "rows": 4,
                "cols": 1,
                "data": [cam.fx, cam.fy, cam.cx, cam.cy],
            },
        }
        if cam.dist_kind != DIST_NONE:
            cam_node["distortion"] = {
                "type": cam.dist_kind,
                "parameters": {
                    "rows": 4,
                    "cols": 1,
                    "data": list(cam.dist_params),
                },
            }
        entries.append(
            {
                "camera": cam_node,
                "T_C_B": {"rows": 4, "cols": 4, "data": T_C_B.ravel().tolist()},
            }
        )
    with open(filename, "w") as f:
        yaml.safe_dump({"cameras": entries}, f)
