"""KITTI Eigen-split dataset (data/kitti_loader_eigen.py equivalent).

Reads the ``eigen_info_<mode>.npz`` index written by
``tcsfm.data.preprocess eigen`` and materializes (target, sources) windows
with boundary-aware neighbour selection (create_kitti_eigen_data.py:76-93):
a sample whose previous/next frame is missing uses the nearest existing
frame on the other side.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from tcsfm_torch.data.common import cached_frame, sample_rng
from tcsfm_torch.data.dataset import relative_lie_alg
from tcsfm_torch.data.transforms import WindowTransform


class EigenDataset:
    def __init__(self, data_dir: str, mode: str = "train",
                 transform: Optional[WindowTransform] = None, seed: int = 0):
        idx_path = os.path.join(data_dir, f"eigen_info_{mode}.npz")
        d = np.load(idx_path, allow_pickle=True)
        self.files = d["files"]
        self.K = d["K"]
        self.poses = d["poses"]
        self.folders = d["folders"]
        self.idxs = d["idxs"]
        self.transform = transform
        self.seed = seed

        # map (folder, frame idx) → row for neighbour lookup
        self.lookup: Dict = {}
        for row, (f, i) in enumerate(zip(self.folders, self.idxs)):
            self.lookup[(str(f), int(i))] = row

        # boundary-aware source rows: prev/next frame, falling back to the
        # opposite side (x2) at sequence boundaries
        self.sources = []
        for row, (f, i) in enumerate(zip(self.folders, self.idxs)):
            f, i = str(f), int(i)
            prev_row = self.lookup.get((f, i - 1))
            next_row = self.lookup.get((f, i + 1))
            if prev_row is None and next_row is not None:
                prev_row = self.lookup.get((f, i + 2), next_row)
            if next_row is None and prev_row is not None:
                next_row = self.lookup.get((f, i - 2), prev_row)
            if prev_row is None and next_row is None:
                prev_row = next_row = row
            self.sources.append((prev_row, next_row))

    def __len__(self) -> int:
        return len(self.files)

    def reseed(self, seed: int) -> None:
        self.seed = seed

    def _load(self, row: int) -> np.ndarray:
        # each row is read up to 3x (as target and as its neighbors' source)
        def decode() -> np.ndarray:
            from PIL import Image

            with Image.open(str(self.files[row])) as im:
                return np.asarray(im.convert("RGB"), np.uint8)

        return cached_frame(self.__dict__.setdefault("_img_cache", {}),
                            row, decode)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        prev_row, next_row = self.sources[idx]
        imgs = [self._load(prev_row), self._load(idx), self._load(next_row)]
        K = self.K[idx].astype(np.float32)

        gt = np.stack([
            relative_lie_alg(self.poses[idx], self.poses[prev_row]),
            relative_lie_alg(self.poses[idx], self.poses[next_row]),
        ])
        lie = np.stack([gt, gt.copy()], axis=1)          # gt == vo placeholder

        if self.transform is not None:
            (o_imgs, K_o, lie_o), (a_imgs, K_a, lie_a) = self.transform(
                imgs, K, lie, sample_rng(self.seed, idx))
        else:
            (o_imgs, K_o, lie_o) = (imgs, K, lie)
            (a_imgs, K_a, lie_a) = (imgs, K, lie)

        return {
            "target_img": np.asarray(o_imgs[1], np.float32),
            "target_img_aug": np.asarray(a_imgs[1], np.float32),
            "source_imgs": np.stack([o_imgs[0], o_imgs[2]]).astype(np.float32),
            "source_imgs_aug": np.stack([a_imgs[0], a_imgs[2]]).astype(np.float32),
            "intrinsics": np.asarray(K_o, np.float32),
            "intrinsics_aug": np.asarray(K_a, np.float32),
            "gt_lie_alg": lie_o[:, 0].astype(np.float32),
            "gt_lie_alg_aug": lie_a[:, 0].astype(np.float32),
            "vo_lie_alg": lie_o[:, 1].astype(np.float32),
            "vo_lie_alg_aug": lie_a[:, 1].astype(np.float32),
            "dt": np.asarray([0.1, -0.1], np.float32),
        }
