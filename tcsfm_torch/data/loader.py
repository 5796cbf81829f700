"""Batch collation and a prefetching loader feeding device arrays.

Replaces the torch DataLoader + ``process_sample_batch`` pair
(run_mono_training.py:101-124, data/kitti_loader.py:60-98): windows are
collated into the stacked NHWC layout the solver consumes
(target [B, H, W, 3], sources [S, B, H, W, 3]) and prefetched on a
background thread so host-side augmentation overlaps device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Sequence

from tcsfm_torch.data.common import decode_pool

import numpy as np


def collate_windows(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """List of window dicts → batch dict.

    Image stacks become source-major [S, B, ...] to match the solver's
    packing (solve_pose_iteratively).
    """
    out: Dict[str, np.ndarray] = {}
    for key in samples[0]:
        stacked = np.stack([s[key] for s in samples])      # [B, ...]
        if key in ("source_imgs", "source_imgs_aug", "gt_lie_alg",
                   "gt_lie_alg_aug", "vo_lie_alg", "vo_lie_alg_aug", "dt"):
            stacked = np.moveaxis(stacked, 0, 1)           # [S, B, ...]
        out[key] = stacked
    return out


class BatchLoader:
    """Shuffling, optionally prefetching batch iterator.

    Drops the ragged tail batch in training (shapes must stay static under
    jit); keeps it padded+masked in eval via ``pad_tail=True``.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 pad_tail: bool = False, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1,
                 decode_threads: int = 8):
        """``batch_size`` is the GLOBAL batch size. With
        ``process_count > 1`` (multi-host data loading), every process
        must construct the loader with the same seed — the shuffle order
        is derived identically everywhere — and each yields only its own
        ``batch_size / process_count`` contiguous rows of every global
        batch, ready for ``shard_process_local_batch``. Multi-process
        requires drop_last (a padded tail would need cross-host-agreed
        masks; eval paths stay single-process or window-sharded)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last and not pad_tail
        self.pad_tail = pad_tail
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        if process_count > 1:
            if batch_size % process_count:
                raise ValueError(
                    f"global batch_size {batch_size} not divisible by "
                    f"process_count {process_count}")
            if not self.drop_last:
                raise ValueError(
                    "multi-process loading requires drop_last=True")
        self.rng = np.random.RandomState(seed)
        # shared pool, resolved at each use (not cached): loaders are
        # constructed per epoch, and a later wider-threaded loader may
        # replace the shared pool — resolving lazily keeps every live
        # loader on the current one
        self._decode_threads = decode_threads

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        nb = len(self)
        local_bs = self.batch_size // self.process_count
        for b in range(nb):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if self.process_count > 1:
                # this process's contiguous rows of the global batch
                idx = idx[self.process_index * local_bs:
                          (self.process_index + 1) * local_bs]
            pool = (decode_pool(self._decode_threads)
                    if self._decode_threads > 0 else None)
            if pool is not None and len(idx) > 1:
                # JPEG decode releases the GIL: fan sample loads across the
                # pool (augmentation draws are per-sample-seeded, so fetch
                # order does not change the data)
                samples = list(pool.map(
                    self.dataset.__getitem__, [int(i) for i in idx]))
            else:
                samples = [self.dataset[int(i)] for i in idx]
            batch = collate_windows(samples)
            pad = self.batch_size - len(idx)
            source_major = (
                "source_imgs", "source_imgs_aug", "gt_lie_alg",
                "gt_lie_alg_aug", "vo_lie_alg", "vo_lie_alg_aug", "dt",
            )
            if pad > 0 and self.pad_tail:
                # repeat the last sample to keep jit shapes static;
                # mask padded rows out with _valid downstream
                def pad_axis(k):
                    return 1 if k in source_major else 0

                batch = {
                    k: np.concatenate(
                        [v] + [v.take([-1], axis=pad_axis(k))] * pad,
                        axis=pad_axis(k),
                    )
                    for k, v in batch.items()
                }
                batch["_valid"] = np.concatenate(
                    [np.ones(len(idx), bool), np.zeros(pad, bool)]
                )
            else:
                batch["_valid"] = np.ones(len(idx), bool)
            yield batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.prefetch <= 0:
            yield from self._batches()
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        err: list = []

        def worker():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:  # surface loader errors in the main thread
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if err:
            raise err[0]
