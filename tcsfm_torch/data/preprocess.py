"""Dataset preprocessing CLIs.

First-party re-implementation of the reference preprocessing pipeline
(SURVEY.md C17) without pykitti/cv2:

  * KITTI odometry → per-sequence resized jpgs + sequence_data.npz
    (fields mirroring data/create_kitti_odometry_data.py:86-152: image
    files, zoom-scaled intrinsics, GT/VO poses, timestamps; cam2 and cam3
    emitted as independent <seq>_02 / <seq>_03 sequences; optional
    static-frame removal :119-149).
  * KITTI raw (Eigen split) → per-sample target/source index + OXTS
    world poses (create_kitti_eigen_data.py:76-121).
  * Eigen GT depth export: velodyne → sparse depth npz
    (export_gt_depth_kitti_eigen.py:63-161).
  * ScanNet → frame-skip subsampled windows with NaN-pose filtering
    (create_scannet_dataset.py:28-109).

Usage:
  python -m tcsfm_torch.data.preprocess odometry --source_dir ... --target_dir ...
  python -m tcsfm_torch.data.preprocess eigen_gt_depth --raw_dir ... --split_file ...
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from tcsfm_torch.data import kitti_io
from tcsfm_torch.data.dataset import SequenceData
from tcsfm_torch.eval.trajectory import np_se3_inv, np_se3_log, np_normalize_rotation

RESOLUTIONS = {
    "low_res": (128, 448), "med_res": (192, 640), "high_res": (256, 832),
}

ODOMETRY_SEQUENCES = ["00", "01", "02", "04", "05", "06", "07", "08", "09", "10"]


def _resize_image(path: str, h: int, w: int):
    from PIL import Image

    with Image.open(path) as im:
        ow, oh = im.size
        out = im.convert("RGB").resize((w, h), resample=Image.LANCZOS)
    return out, w / ow, h / oh


def remove_static_frames(seq: SequenceData, trans_thresh: float = 0.15,
                         rot_thresh: float = 0.003) -> SequenceData:
    """Iteratively drop the first frame of near-static consecutive pairs
    (create_kitti_odometry_data.py:119-149)."""
    keep = np.arange(len(seq))
    while True:
        poses = seq.gt_poses[keep]
        drop = []
        for i in range(0, len(keep) - 1, 2):
            T2 = np_se3_inv(np_normalize_rotation(poses[i + 1]))
            T1 = np_normalize_rotation(poses[i])
            xi = np_se3_log(T2 @ T1)
            if (np.linalg.norm(xi[:3]) < trans_thresh
                    and np.linalg.norm(xi[3:]) < rot_thresh):
                drop.append(i)
        if not drop:
            break
        keep = np.delete(keep, drop)
    return SequenceData(
        name=seq.name,
        intrinsics=seq.intrinsics[keep],
        gt_poses=seq.gt_poses[keep],
        vo_poses=seq.vo_poses[keep],
        timestamps=seq.timestamps[keep],
        image_files=None if seq.image_files is None else seq.image_files[keep],
        images=None if seq.images is None else seq.images[keep],
    )


def preprocess_odometry(source_dir: str, target_dir: str,
                        resolution: str = "med_res",
                        sequences: Optional[List[str]] = None,
                        remove_static: bool = False,
                        also_write_reference_pkl: bool = False) -> None:
    """KITTI odometry → resized jpgs + npz indices, cam2/cam3 as sequences."""
    h, w = RESOLUTIONS[resolution]
    out_root = os.path.join(target_dir, resolution)
    os.makedirs(out_root, exist_ok=True)
    sequences = sequences or ODOMETRY_SEQUENCES

    for s in sequences:
        seq_dir = os.path.join(source_dir, "sequences", s)
        times = kitti_io.read_odometry_times(seq_dir)
        K_by_cam = kitti_io.odometry_intrinsics(seq_dir)
        pose_file = os.path.join(source_dir, "poses", f"{s}.txt")
        if os.path.exists(pose_file):
            gt = kitti_io.read_odometry_poses(pose_file)
        else:
            gt = np.tile(np.eye(4), (len(times), 1, 1))

        for cam in ("02", "03"):
            img_dir = os.path.join(seq_dir, f"image_{cam[-1]}")
            if not os.path.isdir(img_dir):
                continue
            files = sorted(os.listdir(img_dir))
            out_seq = os.path.join(out_root, f"{s}_{cam}")
            os.makedirs(os.path.join(out_seq, "image_2"), exist_ok=True)

            n = min(len(files), len(gt), len(times))
            K = np.broadcast_to(K_by_cam[cam], (n, 3, 3)).astype(np.float32).copy()
            out_files = []
            for i, fn in enumerate(files[:n]):
                img, zx, zy = _resize_image(os.path.join(img_dir, fn), h, w)
                new_fn = os.path.join(out_seq, "image_2",
                                      fn.replace(".png", ".jpg"))
                img.save(new_fn, quality=95)
                K[i, 0] *= zx
                K[i, 1] *= zy
                out_files.append(new_fn)

            seq_data = SequenceData(
                name=f"{s}_{cam}",
                intrinsics=K,
                gt_poses=gt[:n],
                vo_poses=gt[:n].copy(),   # GT placeholder, like the reference
                timestamps=times[:n],
                image_files=np.asarray(out_files),
            )
            if remove_static:
                seq_data = remove_static_frames(seq_data)
            seq_data.save_npz(os.path.join(out_seq, "sequence_data.npz"))
            if also_write_reference_pkl:
                import pickle

                with open(os.path.join(out_seq, "sequence_data.pkl"), "wb") as f:
                    pickle.dump({
                        "cam_02": seq_data.image_files,
                        "intrinsics_left": seq_data.intrinsics,
                        "sparse_gt_pose": seq_data.gt_poses,
                        "sparse_vo": seq_data.vo_poses,
                        "ts": seq_data.timestamps,
                    }, f)
            print(f"wrote {s}_{cam}: {len(seq_data)} frames")


def export_eigen_gt_depth(raw_dir: str, split_file: str, out_path: str) -> None:
    """Velodyne → per-sample GT depth maps for the Eigen test split.

    split_file lines: '<date>/<drive> <frame_idx> <l|r>'.
    Writes npz {'data': object array of [H, W] depth maps}.
    """
    depths = []
    with open(split_file) as f:
        lines = [ln.split() for ln in f if ln.strip()]
    for parts in lines:
        folder, idx = parts[0], int(parts[1])
        date = folder.split("/")[0]
        calib = kitti_io.raw_cam_calib(os.path.join(raw_dir, date))
        wh = calib["im_size"]
        w, h = int(wh[0]), int(wh[1])
        velo = os.path.join(raw_dir, folder, "velodyne_points", "data",
                            f"{idx:010d}.bin")
        depths.append(kitti_io.velodyne_to_depth(velo, calib, h, w))
    np.savez_compressed(out_path, data=np.asarray(depths, dtype=object))
    print(f"wrote {len(depths)} gt depth maps -> {out_path}")


def preprocess_eigen(raw_dir: str, target_dir: str, split_dir: str,
                     resolution: str = "med_res") -> None:
    """KITTI raw drives of the Eigen split → resized jpgs + npz index with
    OXTS-derived world camera poses (create_kitti_eigen_data.py:76-121)."""
    h, w = RESOLUTIONS[resolution]
    out_root = os.path.join(target_dir, resolution)
    os.makedirs(out_root, exist_ok=True)

    for mode in ("train", "val", "test"):
        split_file = os.path.join(split_dir, f"{mode}_files.txt")
        if not os.path.exists(split_file):
            continue
        with open(split_file) as f:
            lines = [ln.split() for ln in f if ln.strip()]

        index = []
        drives = {}
        for parts in lines:
            folder, idx = parts[0], int(parts[1])
            if folder not in drives:
                date = folder.split("/")[0]
                drive_dir = os.path.join(raw_dir, folder)
                calib = kitti_io.raw_cam_calib(os.path.join(raw_dir, date))
                T_imu_w = kitti_io.load_oxts_poses(drive_dir)
                # camera-frame world poses: T_w_cam = T_w_imu · T_imu_cam
                T_velo_cam = calib["T_velo_cam"]
                T_imu_velo = calib["T_imu_velo"]
                R_rect = calib["R_rect_00"]
                T_cam_imu = R_rect @ T_velo_cam @ T_imu_velo
                T_w_cam = T_imu_w @ np.linalg.inv(T_cam_imu)
                K = calib["P_rect_02"][:3, :3]
                drives[folder] = (drive_dir, K, T_w_cam)
            drive_dir, K, T_w_cam = drives[folder]

            img = os.path.join(drive_dir, "image_02", "data", f"{idx:010d}.png")
            if not os.path.exists(img):
                continue
            out_dir = os.path.join(out_root, folder.replace("/", "_"))
            os.makedirs(out_dir, exist_ok=True)
            im, zx, zy = _resize_image(img, h, w)
            out_img = os.path.join(out_dir, f"{idx:010d}.jpg")
            im.save(out_img, quality=95)
            Kz = K.copy()
            Kz[0] *= zx
            Kz[1] *= zy
            index.append({
                "file": out_img, "K": Kz.astype(np.float32),
                "pose": T_w_cam[idx], "folder": folder, "idx": idx,
            })
        np.savez_compressed(
            os.path.join(out_root, f"eigen_info_{mode}.npz"),
            files=np.asarray([e["file"] for e in index]),
            K=np.stack([e["K"] for e in index]) if index else np.zeros((0, 3, 3)),
            poses=np.stack([e["pose"] for e in index]) if index else np.zeros((0, 4, 4)),
            folders=np.asarray([e["folder"] for e in index]),
            idxs=np.asarray([e["idx"] for e in index]),
        )
        print(f"eigen {mode}: {len(index)} samples")


def preprocess_scannet(source_dir: str, target_dir: str, scenes: List[str],
                       frame_skip: int = 6, size=(192, 640)) -> None:
    """ScanNet exported scenes → subsampled npz sequences with NaN-pose
    filtering and resized depth (create_scannet_dataset.py:28-109).

    Expects <scene>/{color/*.jpg, depth/*.png|pgm, pose/*.txt, intrinsic/}.
    """
    from PIL import Image

    h, w = size
    os.makedirs(target_dir, exist_ok=True)
    for scene in scenes:
        sdir = os.path.join(source_dir, scene)
        color_dir = os.path.join(sdir, "color")
        pose_dir = os.path.join(sdir, "pose")
        depth_dir = os.path.join(sdir, "depth")
        frames = sorted(int(f.split(".")[0]) for f in os.listdir(color_dir))
        frames = frames[::frame_skip]

        K = np.loadtxt(os.path.join(
            sdir, "intrinsic", "intrinsic_color.txt"))[:3, :3]

        imgs, poses, depths, keep = [], [], [], []
        for fi in frames:
            pose = np.loadtxt(os.path.join(pose_dir, f"{fi}.txt"))
            if not np.all(np.isfinite(pose)):
                continue
            with Image.open(os.path.join(color_dir, f"{fi}.jpg")) as im:
                ow, oh = im.size
                imgs.append(np.asarray(
                    im.convert("RGB").resize((w, h), Image.LANCZOS),
                    dtype=np.uint8))
            dpath = None
            for ext in (".png", ".pgm"):
                p = os.path.join(depth_dir, f"{fi}{ext}")
                if os.path.exists(p):
                    dpath = p
                    break
            if dpath:
                with Image.open(dpath) as dm:
                    d = np.asarray(dm.resize((w, h), Image.NEAREST),
                                   dtype=np.float32) / 1000.0
                depths.append(d)
            poses.append(pose)
            keep.append(fi)

        Kz = K.copy()
        Kz[0] *= w / ow
        Kz[1] *= h / oh
        n = len(keep)
        seq = SequenceData(
            name=scene,
            intrinsics=np.broadcast_to(
                Kz.astype(np.float32), (n, 3, 3)).copy(),
            gt_poses=np.stack(poses),
            vo_poses=np.stack(poses).copy(),
            timestamps=np.asarray(keep, np.float64) / 30.0,
            images=np.stack(imgs).astype(np.float32) / 255.0,
            depths=np.stack(depths) if depths else None,
        )
        seq.save_npz(os.path.join(target_dir, f"{scene}.npz"))
        print(f"scannet {scene}: {n} frames")


def main(argv=None):
    p = argparse.ArgumentParser(description="tcsfm dataset preprocessing")
    sub = p.add_subparsers(dest="cmd", required=True)

    po = sub.add_parser("odometry")
    po.add_argument("--source_dir", required=True)
    po.add_argument("--target_dir", required=True)
    po.add_argument("--resolution", default="med_res")
    po.add_argument("--sequences", nargs="+", default=None)
    po.add_argument("--remove_static", action="store_true")
    po.add_argument("--reference_pkl", action="store_true")

    pe = sub.add_parser("eigen")
    pe.add_argument("--raw_dir", required=True)
    pe.add_argument("--target_dir", required=True)
    pe.add_argument("--split_dir", required=True)
    pe.add_argument("--resolution", default="med_res")

    pg = sub.add_parser("eigen_gt_depth")
    pg.add_argument("--raw_dir", required=True)
    pg.add_argument("--split_file", required=True)
    pg.add_argument("--out", required=True)

    ps = sub.add_parser("scannet")
    ps.add_argument("--source_dir", required=True)
    ps.add_argument("--target_dir", required=True)
    ps.add_argument("--scenes", nargs="+", required=True)
    ps.add_argument("--frame_skip", type=int, default=6)

    args = p.parse_args(argv)
    if args.cmd == "odometry":
        preprocess_odometry(args.source_dir, args.target_dir, args.resolution,
                            args.sequences, args.remove_static,
                            args.reference_pkl)
    elif args.cmd == "eigen":
        preprocess_eigen(args.raw_dir, args.target_dir, args.split_dir,
                         args.resolution)
    elif args.cmd == "eigen_gt_depth":
        export_eigen_gt_depth(args.raw_dir, args.split_file, args.out)
    elif args.cmd == "scannet":
        preprocess_scannet(args.source_dir, args.target_dir, args.scenes,
                           args.frame_skip)


if __name__ == "__main__":
    main()
