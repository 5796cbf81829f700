"""Direct parsers for KITTI file formats (pykitti replacement).

The reference preprocessing depends on pykitti (data/create_kitti_odometry
_data.py:5, create_kitti_eigen_data.py); that package is not a
dependency, and the formats are simple text/binary — parse them
first-party. A copy of ``tcsfm/data/kitti_io.py``.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_calib_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI calib txt: 'KEY: v v v ...' lines → dict of float arrays."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            try:
                out[key.strip()] = np.array(
                    [float(v) for v in vals.strip().split()])
            except ValueError:
                pass
    return out


def odometry_intrinsics(seq_dir: str) -> Dict[str, np.ndarray]:
    """K matrices of cam2/cam3 from sequences/<seq>/calib.txt (P2/P3)."""
    calib = read_calib_file(os.path.join(seq_dir, "calib.txt"))
    out = {}
    for cam, key in (("02", "P2"), ("03", "P3")):
        P = calib[key].reshape(3, 4)
        out[cam] = P[:3, :3].copy()
    return out


def read_odometry_times(seq_dir: str) -> np.ndarray:
    return np.loadtxt(os.path.join(seq_dir, "times.txt")).reshape(-1)


def read_odometry_poses(path: str) -> np.ndarray:
    """poses/<seq>.txt: N lines of flattened 3x4 → [N, 4, 4]."""
    flat = np.loadtxt(path).reshape(-1, 3, 4)
    n = flat.shape[0]
    out = np.tile(np.eye(4), (n, 1, 1))
    out[:, :3, :] = flat
    return out


# --------------------------------------------------------------------------
# KITTI raw (Eigen split): OXTS → poses, velodyne → depth
# --------------------------------------------------------------------------

_EARTH_R = 6378137.0


def oxts_to_pose(oxts: np.ndarray, scale: float) -> np.ndarray:
    """One OXTS packet row → 4x4 world pose (IMU frame), mercator projection.

    Standard KITTI raw devkit conversion: row fields are
    lat lon alt roll pitch yaw ... (only the first 6 used).
    """
    lat, lon, alt, roll, pitch, yaw = oxts[:6]
    tx = scale * lon * np.pi * _EARTH_R / 180.0
    ty = scale * _EARTH_R * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    tz = alt

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    R = rz(yaw) @ ry(pitch) @ rx(roll)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = [tx, ty, tz]
    return T


def load_oxts_poses(drive_dir: str) -> np.ndarray:
    """All OXTS packets of a drive → [N, 4, 4] IMU world poses."""
    oxts_dir = os.path.join(drive_dir, "oxts", "data")
    files = sorted(os.listdir(oxts_dir))
    rows = [np.loadtxt(os.path.join(oxts_dir, f)) for f in files]
    scale = np.cos(rows[0][0] * np.pi / 180.0)
    return np.stack([oxts_to_pose(r, scale) for r in rows])


def raw_cam_calib(date_dir: str) -> Dict[str, np.ndarray]:
    """cam-to-cam / velo-to-cam / imu-to-velo calib for a raw date dir."""
    c2c = read_calib_file(os.path.join(date_dir, "calib_cam_to_cam.txt"))
    v2c = read_calib_file(os.path.join(date_dir, "calib_velo_to_cam.txt"))
    i2v = read_calib_file(os.path.join(date_dir, "calib_imu_to_velo.txt"))

    T_v2c = np.eye(4)
    T_v2c[:3, :3] = v2c["R"].reshape(3, 3)
    T_v2c[:3, 3] = v2c["T"]
    T_i2v = np.eye(4)
    T_i2v[:3, :3] = i2v["R"].reshape(3, 3)
    T_i2v[:3, 3] = i2v["T"]
    R_rect = np.eye(4)
    R_rect[:3, :3] = c2c["R_rect_00"].reshape(3, 3)
    return {
        "P_rect_02": c2c["P_rect_02"].reshape(3, 4),
        "P_rect_03": c2c["P_rect_03"].reshape(3, 4),
        "R_rect_00": R_rect,
        "T_velo_cam": T_v2c,
        "T_imu_velo": T_i2v,
        "im_size": c2c.get("S_rect_02", np.array([1242.0, 375.0])),
    }


def velodyne_to_depth(velo_path: str, calib: Dict[str, np.ndarray],
                      h: int, w: int, cam: int = 2) -> np.ndarray:
    """Project a velodyne scan into a sparse depth map (Eigen GT export;
    equivalent of data/export_gt_depth_kitti_eigen.py:63-161)."""
    scan = np.fromfile(velo_path, dtype=np.float32).reshape(-1, 4)
    scan[:, 3] = 1.0
    P = calib[f"P_rect_0{cam}"] @ calib["R_rect_00"] @ calib["T_velo_cam"]
    pts = scan @ P.T                                  # [N, 3]
    keep = pts[:, 2] > 1e-3
    pts = pts[keep]
    u = np.round(pts[:, 0] / pts[:, 2]).astype(int)
    v = np.round(pts[:, 1] / pts[:, 2]).astype(int)
    z = pts[:, 2]
    ok = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    u, v, z = u[ok], v[ok], z[ok]
    depth = np.zeros((h, w), np.float32)
    # keep the CLOSEST point per pixel (duplicates resolved by min depth)
    order = np.argsort(-z)
    depth[v[order], u[order]] = z[order]
    return depth
