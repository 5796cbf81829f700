"""ScanNet test dataset (data/scannet_test_loader.py equivalent).

Builds (target, 2 sources) windows over a preprocessed ScanNet scene with
the DeepV2D frame gap (s = 8 between window frames,
scannet_test_loader.py:42), exposing GT depth for evaluation.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from tcsfm_torch.data.common import sample_rng
from tcsfm_torch.data.dataset import SequenceData, relative_lie_alg
from tcsfm_torch.data.transforms import WindowTransform


class ScanNetTestDataset:
    def __init__(self, sequences: List[SequenceData], frame_gap: int = 8,
                 transform: Optional[WindowTransform] = None, seed: int = 0):
        self.sequences = list(sequences)
        self.gap = frame_gap
        self.transform = transform
        self.seed = seed

        self.index = []
        for si, seq in enumerate(self.sequences):
            n = len(seq)
            # windows (t - gap, t, t + gap): target in the middle
            for t in range(frame_gap, n - frame_gap):
                self.index.append((si, t))

    def __len__(self) -> int:
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        si, t = self.index[idx]
        seq = self.sequences[si]
        g = self.gap
        frames = [t - g, t, t + g]
        imgs = [seq.load_image(f) for f in frames]
        K = np.asarray(seq.intrinsics[t], np.float32)

        gt = np.stack([
            relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t - g]),
            relative_lie_alg(seq.gt_poses[t], seq.gt_poses[t + g]),
        ])
        lie = np.stack([gt, gt.copy()], axis=1)

        if self.transform is not None:
            (o_imgs, K_o, lie_o), (a_imgs, K_a, lie_a) = self.transform(
                imgs, K, lie, sample_rng(self.seed, idx))
        else:
            (o_imgs, K_o, lie_o) = (imgs, K, lie)
            (a_imgs, K_a, lie_a) = (imgs, K, lie)

        out = {
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
            "dt": np.asarray([g / 30.0, -g / 30.0], np.float32),
        }
        if seq.depths is not None:
            out["gt_depth"] = np.asarray(seq.depths[t], np.float32)
            # GT relative pose matrices for the DeepV2D pose metrics
            out["gt_pose_mats"] = np.stack([
                np.linalg.inv(seq.gt_poses[t]) @ seq.gt_poses[t - g],
                np.linalg.inv(seq.gt_poses[t]) @ seq.gt_poses[t + g],
            ]).astype(np.float32)
        return out
