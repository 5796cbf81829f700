"""Sequence containers and the window dataset.

Replaces the reference loaders (data/kitti_loader_stereo.py,
data/kitti_loader.py) with a lazy, index-based design: a ``SequenceData``
holds per-frame metadata (file names or in-memory images, intrinsics, GT /
VO poses, timestamps); ``SfMWindowDataset`` builds window indices over many
sequences and materializes numpy training windows on demand.

Reads both this framework's ``.npz`` index format and the reference's
``sequence_data.pkl`` (data/kitti_loader_stereo.py:227-236) so existing
preprocessed KITTI trees work unmodified.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tcsfm_torch.data.common import cached_frame, sample_rng
from tcsfm_torch.data.transforms import WindowTransform
from tcsfm_torch.data.windows import build_windows, target_source_split
from tcsfm_torch.eval.trajectory import np_normalize_rotation, np_se3_inv, np_se3_log


@dataclass
class SequenceData:
    """Per-frame metadata for one video sequence."""

    name: str
    intrinsics: np.ndarray                 # [N, 3, 3]
    gt_poses: np.ndarray                   # [N, 4, 4] world-from-camera
    vo_poses: np.ndarray                   # [N, 4, 4]
    timestamps: np.ndarray                 # [N]
    image_files: Optional[np.ndarray] = None   # [N] paths
    images: Optional[np.ndarray] = None        # [N, H, W, 3] float32 in [0,1]
    depths: Optional[np.ndarray] = None        # [N, H, W] optional GT depth

    def __len__(self) -> int:
        return len(self.timestamps)

    @property
    def uint8_sourced(self) -> bool:
        """True when every frame's float values are exactly k/255 with k
        uint8 — file-backed sequences (JPEG/PNG decode to uint8) and
        uint8-stored in-memory arrays. Enables the sampler's single-pass
        "uint8" exact mode (ops/warp_mxu); in-memory float sequences
        (synthetic, ScanNet npz) are not quantized."""
        if self.images is not None:
            return self.images.dtype == np.uint8
        return self.image_files is not None

    def load_image(self, i: int) -> np.ndarray:
        if self.images is not None:
            im = self.images[i]
            if im.dtype == np.uint8:
                return np.asarray(im, np.float32) / 255.0
            return im

        def decode() -> np.ndarray:
            from PIL import Image

            with Image.open(self.image_files[i]) as im:
                return np.asarray(im.convert("RGB"), dtype=np.uint8)

        return cached_frame(self.__dict__.setdefault("_img_cache", {}),
                            i, decode)

    # --- serialization ----------------------------------------------------

    @classmethod
    def from_reference_pkl(cls, seq_dir: str, name: str = "") -> "SequenceData":
        """Read the reference's per-sequence pickle
        (keys per data/create_kitti_odometry_data.py:86-152)."""
        with open(os.path.join(seq_dir, "sequence_data.pkl"), "rb") as f:
            d = pickle.load(f)
        files = np.asarray(
            [os.path.join(seq_dir, os.path.basename(str(p))) for p in
             np.asarray(d["cam_02"]).reshape(-1)]
        )
        return cls(
            name=name or os.path.basename(seq_dir),
            intrinsics=np.asarray(d["intrinsics_left"], np.float32),
            gt_poses=np.asarray(d["sparse_gt_pose"], np.float64),
            vo_poses=np.asarray(d["sparse_vo"], np.float64),
            timestamps=np.asarray(d["ts"], np.float64).reshape(-1),
            image_files=files,
        )

    @classmethod
    def from_npz(cls, path: str) -> "SequenceData":
        d = np.load(path, allow_pickle=True)
        kw = dict(
            name=str(d["name"]),
            intrinsics=d["intrinsics"],
            gt_poses=d["gt_poses"],
            vo_poses=d["vo_poses"],
            timestamps=d["timestamps"],
        )
        if "image_files" in d:
            kw["image_files"] = d["image_files"]
        if "images" in d:
            kw["images"] = d["images"]
        if "depths" in d:
            kw["depths"] = d["depths"]
        return cls(**kw)

    @staticmethod
    def probe_uint8_sourced(seq_dir: str, seq_name: str) -> bool:
        """``uint8_sourced`` of the sequence stored in ``seq_dir`` WITHOUT
        materializing its image payload: for an npz index, only the
        ``images`` member's .npy header (dtype) is read from the zip
        stream; reference-pkl layouts are file-backed (always uint8
        decodes). Lets the CLIs pick the sampler mode up front while
        still loading sequences one at a time (holding every sequence's
        in-memory frames simultaneously was a multi-GB regression)."""
        npz = os.path.join(seq_dir, "sequence_data.npz")
        if not os.path.exists(npz):
            return True                        # pkl layout: file-backed
        import zipfile

        from numpy.lib import format as npfmt

        with zipfile.ZipFile(npz) as z:
            names = set(z.namelist())
            if "images.npy" in names:
                with z.open("images.npy") as f:
                    version = npfmt.read_magic(f)
                    if version == (1, 0):
                        _, _, dtype = npfmt.read_array_header_1_0(f)
                    else:
                        _, _, dtype = npfmt.read_array_header_2_0(f)
                return dtype == np.uint8
            return "image_files.npy" in names

    def save_npz(self, path: str) -> None:
        kw = dict(
            name=self.name, intrinsics=self.intrinsics,
            gt_poses=self.gt_poses, vo_poses=self.vo_poses,
            timestamps=self.timestamps,
        )
        if self.image_files is not None:
            kw["image_files"] = self.image_files
        if self.images is not None:
            kw["images"] = self.images
        if self.depths is not None:
            kw["depths"] = self.depths
        np.savez_compressed(path, **kw)


def sequence_sources(data_dir: str, seq_names: Sequence[str]
                     ) -> Dict[str, "Callable[[], SequenceData]"]:
    """name -> zero-arg LAZY loader per sequence directory (npz index if
    present, else the reference pkl layout). The single resolution point
    for the eval CLIs; callers iterate and load ONE sequence at a time so
    in-memory image payloads are never all held simultaneously."""
    import functools

    out: Dict[str, "Callable[[], SequenceData]"] = {}
    for seq_name in seq_names:
        d = os.path.join(data_dir, seq_name)
        npz = os.path.join(d, "sequence_data.npz")
        if os.path.exists(npz):
            out[seq_name] = functools.partial(SequenceData.from_npz, npz)
        else:
            out[seq_name] = functools.partial(
                SequenceData.from_reference_pkl, d, seq_name)
    return out


def sequences_uint8_sourced(data_dir: str, seq_names: Sequence[str]) -> bool:
    """All sequences' ``uint8_sourced`` via header probes (no image data
    loaded) — the sampler-mode gate the eval CLIs consult up front."""
    return all(
        SequenceData.probe_uint8_sourced(os.path.join(data_dir, n), n)
        for n in seq_names)


def relative_lie_alg(T_target: np.ndarray, T_source: np.ndarray) -> np.ndarray:
    """log(T_target^{-1} · T_source): source→target pose change
    (kitti_loader_stereo.py:129-147)."""
    T2 = np_se3_inv(np_normalize_rotation(np.asarray(T_target, np.float64)))
    T1 = np_normalize_rotation(np.asarray(T_source, np.float64))
    return np_se3_log(T2 @ T1).astype(np.float32)


class SfMWindowDataset:
    """Window dataset over one or more sequences.

    ``__getitem__`` returns a dict of numpy arrays:
      target_img / target_img_aug: [H, W, 3]
      source_imgs / source_imgs_aug: [S, H, W, 3]
      intrinsics / intrinsics_aug: [3, 3]
      gt_lie_alg / gt_lie_alg_aug, vo_lie_alg / vo_lie_alg_aug: [S, 6]
      dt: [S] timestamps deltas
    """

    def __init__(
        self,
        sequences: Sequence[SequenceData],
        seq_len: int = 3,
        transform: Optional[WindowTransform] = None,
        correction_rate: int = 1,
        skip: int = 1,
        augment_motion: bool = False,
        num_frames: Optional[int] = None,
        seed: int = 0,
    ):
        self.sequences = list(sequences)
        self.seq_len = seq_len
        self.transform = transform
        self.seed = seed

        self.index: List[Tuple[int, np.ndarray]] = []
        for si, seq in enumerate(self.sequences):
            wins = build_windows(
                len(seq), seq_len, correction_rate=correction_rate, skip=skip,
                augment_motion=augment_motion, num_frames=num_frames,
            )
            for w in wins:
                self.index.append((si, w))

        self.target_idx, self.source_idx = target_source_split(seq_len)

    def __len__(self) -> int:
        return len(self.index)

    def reseed(self, seed: int) -> None:
        """Per-epoch reseed (run_mono_training.py:168)."""
        self.seed = seed

    def _rng_for(self, idx: int) -> np.random.RandomState:
        return sample_rng(self.seed, idx)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        si, frames = self.index[idx]
        seq = self.sequences[si]
        imgs = [seq.load_image(f) for f in frames]
        K = np.asarray(seq.intrinsics[frames[self.target_idx]], np.float32)

        gt = np.stack([
            relative_lie_alg(seq.gt_poses[frames[self.target_idx]],
                             seq.gt_poses[frames[s]])
            for s in self.source_idx
        ])
        vo = np.stack([
            relative_lie_alg(seq.vo_poses[frames[self.target_idx]],
                             seq.vo_poses[frames[s]])
            for s in self.source_idx
        ])
        dt = np.asarray([
            seq.timestamps[frames[self.target_idx]] - seq.timestamps[frames[s]]
            for s in self.source_idx
        ], np.float32)
        lie = np.stack([gt, vo], axis=1)          # [S, 2, 6]

        if self.transform is not None:
            (o_imgs, K_o, lie_o), (a_imgs, K_a, lie_a) = self.transform(
                imgs, K, lie, self._rng_for(idx)
            )
        else:
            (o_imgs, K_o, lie_o) = (imgs, K, lie)
            (a_imgs, K_a, lie_a) = (imgs, K, lie)

        t, s_idx = self.target_idx, self.source_idx
        out = {
            "target_img": np.asarray(o_imgs[t], np.float32),
            "target_img_aug": np.asarray(a_imgs[t], np.float32),
            "source_imgs": np.stack([o_imgs[i] for i in s_idx]).astype(np.float32),
            "source_imgs_aug": np.stack([a_imgs[i] for i in s_idx]).astype(np.float32),
            "intrinsics": np.asarray(K_o, np.float32),
            "intrinsics_aug": np.asarray(K_a, np.float32),
            "gt_lie_alg": lie_o[:, 0].astype(np.float32),
            "gt_lie_alg_aug": lie_a[:, 0].astype(np.float32),
            "vo_lie_alg": lie_o[:, 1].astype(np.float32),
            "vo_lie_alg_aug": lie_a[:, 1].astype(np.float32),
            "dt": dt,
        }
        return out
