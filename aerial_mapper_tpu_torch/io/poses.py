"""Pose ingestion: Standard, ROS-csv, PIX4D, COLMAP formats.

The port's own copy of ``aerial_mapper_tpu/io/poses.py`` (host numpy only;
the port imports nothing of the JAX package). Replaces ``io::AerialMapperIO::loadPosesFromFile``
(``aerial_mapper_io/src/aerial-mapper-io.cc:35-121``). The reference
implements only the Standard text format (``x y z qw qx qy qz``,
cc:103-121) and ROS csv (cc:58-101); its COLMAP/PIX4D branches are
``LOG(FATAL) "Not yet implemented!"`` stubs (cc:46-51). The north star
requires real PIX4D/COLMAP ingestion, so those are implemented here.

All loaders return host-side float64 arrays (UTM-scale coordinates):
``(quats [N, 4] wxyz, trans [N, 3])`` for **body-to-world** (T_G_B) poses,
plus optional per-pose metadata. Origin subtraction mirrors
``subtractOriginFromPoses`` (cc:263-270).
"""

from __future__ import annotations

import enum
from typing import List, Optional, Tuple

import numpy as np


class PoseFormat(enum.Enum):
    STANDARD = "standard"  # x y z qw qx qy qz (aerial-mapper-io.cc:103-121)
    ROS = "ros"  # t x y z qx qy qz qw (aerial-mapper-io.cc:58-101)
    PIX4D = "pix4d"  # name x y z omega phi kappa [deg]
    COLMAP = "colmap"  # images.txt: id qw qx qy qz tx ty tz cam_id name


def _normalize_rows(q: np.ndarray) -> np.ndarray:
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _quat_from_matrix_np(R: np.ndarray) -> np.ndarray:
    """[3,3] -> wxyz (float64, w>=0)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array([(R[2, 1] - R[1, 2]) / s, 0.25 * s,
                      (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s])
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array([(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s,
                      0.25 * s, (R[1, 2] + R[2, 1]) / s])
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array([(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s,
                      (R[1, 2] + R[2, 1]) / s, 0.25 * s])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def _rot_matrix_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


# ---------------------------------------------------------------------------


def _load_standard(filename: str):
    data = np.loadtxt(filename, dtype=np.float64).reshape(-1, 7)
    trans = data[:, 0:3]
    quats = _normalize_rows(data[:, 3:7])  # qw qx qy qz
    return quats, trans, None


def _load_ros_csv(filename: str):
    rows = []
    with open(filename) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("%"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            try:
                rows.append([float(p) for p in parts[:8]])
            except ValueError:
                if not rows:
                    # a plain (uncommented) header row like
                    # 'time,x,y,z,qx,qy,qz,qw' — common in spreadsheet
                    # round-trips; skip it
                    continue
                raise ValueError(
                    f"{filename}:{lineno}: malformed pose row {line!r}"
                ) from None
    data = np.asarray(rows, dtype=np.float64)
    timestamps = data[:, 0]
    trans = data[:, 1:4]
    qx, qy, qz, qw = data[:, 4], data[:, 5], data[:, 6], data[:, 7]
    quats = _normalize_rows(np.stack([qw, qx, qy, qz], axis=1))
    return quats, trans, timestamps


def _load_pix4d(filename: str):
    """PIX4D calibrated external parameters: ``name X Y Z omega phi kappa``.

    omega/phi/kappa in degrees define the photogrammetric rotation
    R = Rx(omega) Ry(phi) Rz(kappa) mapping camera->world axes in the
    photogrammetric camera frame (x right, y up, z backward). We convert to
    the CV frame (x right, y down, z forward) used everywhere else by
    right-multiplying diag(1, -1, -1).
    """
    names: List[str] = []
    quats, trans = [], []
    with open(filename) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 7:
                continue
            names.append(parts[0])
            x, y, z, om, ph, ka = (float(p) for p in parts[1:7])
            om, ph, ka = np.deg2rad([om, ph, ka])
            co, so = np.cos(om), np.sin(om)
            cp, sp = np.cos(ph), np.sin(ph)
            ck, sk = np.cos(ka), np.sin(ka)
            Rx = np.array([[1, 0, 0], [0, co, -so], [0, so, co]])
            Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            Rz = np.array([[ck, -sk, 0], [sk, ck, 0], [0, 0, 1]])
            R_photo = Rx @ Ry @ Rz  # camera(photogrammetric)->world
            R_cv = R_photo @ np.diag([1.0, -1.0, -1.0])
            quats.append(_quat_from_matrix_np(R_cv))
            trans.append([x, y, z])
    return (
        np.asarray(quats, np.float64),
        np.asarray(trans, np.float64),
        names,
    )


def _load_colmap(filename: str):
    """COLMAP images.txt: every other line is
    ``IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME`` with (q, t) world->cam.

    Returns camera-to-world poses sorted by image name (COLMAP files are
    unordered); the 2-D point observation lines are skipped.
    """
    entries = []
    with open(filename) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 10:
            continue
        try:
            qw, qx, qy, qz = (float(p) for p in parts[1:5])
            tx, ty, tz = (float(p) for p in parts[5:8])
        except ValueError:
            continue
        name = parts[9]
        q_wc_cam = np.array([qw, qx, qy, qz])
        q_wc_cam = q_wc_cam / np.linalg.norm(q_wc_cam)
        R_cw = _rot_matrix_np(q_wc_cam)  # world->camera
        t_cw = np.array([tx, ty, tz])
        R_wc = R_cw.T
        t_G_C = -R_wc @ t_cw
        entries.append((name, _quat_from_matrix_np(R_wc), t_G_C))
        # images.txt alternates pose lines with 2-D observation lines;
        # skip the observation line following each pose
        if i < len(lines):
            i += 1
    entries.sort(key=lambda e: e[0])
    names = [e[0] for e in entries]
    quats = np.asarray([e[1] for e in entries], np.float64)
    trans = np.asarray([e[2] for e in entries], np.float64)
    return quats, trans, names


def load_poses(
    filename: str, fmt: PoseFormat = PoseFormat.STANDARD
) -> Tuple[np.ndarray, np.ndarray, Optional[list]]:
    """Load body/camera poses -> (quats [N,4] wxyz, trans [N,3], meta).

    ``meta`` is timestamps (ROS), image names (PIX4D/COLMAP) or None.
    """
    if fmt == PoseFormat.STANDARD:
        return _load_standard(filename)
    if fmt == PoseFormat.ROS:
        return _load_ros_csv(filename)
    if fmt == PoseFormat.PIX4D:
        return _load_pix4d(filename)
    if fmt == PoseFormat.COLMAP:
        return _load_colmap(filename)
    raise ValueError(f"Unknown pose format: {fmt}")


def save_poses_standard(filename: str, quats: np.ndarray,
                        trans: np.ndarray) -> None:
    """Write the Standard format (x y z qw qx qy qz), the reference's
    interchange format (toStandardFormat, aerial-mapper-io.cc:183-192)."""
    with open(filename, "w") as f:
        for q, t in zip(quats, trans):
            f.write(
                f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.12f} {q[1]:.12f} {q[2]:.12f} {q[3]:.12f}\n"
            )


def subtract_origin(trans: np.ndarray, origin) -> np.ndarray:
    """subtractOriginFromPoses (aerial-mapper-io.cc:263-270), out-of-place."""
    return trans - np.asarray(origin, dtype=np.float64)[None, :]


def camera_to_body_poses(rig, quats_G_C, trans_G_C, camera_index: int = 0):
    """Convert refined CAMERA poses back to BODY poses through the rig:
    T_G_B = T_G_C * T_C_B (ortho-backward-grid.cc:230-233 inverted).
    Shared by the --refine_poses plumbing (cli/common.py) and the
    refine-poses CLI. Returns (quats_G_B [N, 4], trans_G_B [N, 3])
    float64."""
    q_cb = rig.T_C_B_quats[camera_index]
    R_cb = _rot_matrix_np(q_cb)
    t_cb = rig.T_C_B_trans[camera_index]
    quats_G_C = np.asarray(quats_G_C, np.float64)
    trans_G_C = np.asarray(trans_G_C, np.float64)
    n = quats_G_C.shape[0]
    quats_b = np.zeros((n, 4))
    trans_b = np.zeros((n, 3))
    for i in range(n):
        R_gc = _rot_matrix_np(quats_G_C[i])
        quats_b[i] = _quat_from_matrix_np(R_gc @ R_cb)
        trans_b[i] = trans_G_C[i] + R_gc @ t_cb
    return quats_b, trans_b
