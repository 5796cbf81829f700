"""Shared host-side data helpers: per-sample RNG streams and the
decoded-frame cache used by every dataset."""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict

import numpy as np

CACHE_FRAMES = 128


def sample_rng(seed: int, idx: int) -> np.random.RandomState:
    """Per-sample augmentation stream: deterministic in (epoch seed, sample
    index) regardless of fetch ORDER — so loaders can decode samples on a
    thread pool, and multi-host loaders draw identical augmentations for
    the same global sample."""
    return np.random.RandomState(
        (1_000_003 * (seed + 1) + idx) % (2 ** 31 - 1))


def cached_frame(cache: Dict, key, decode: Callable[[], np.ndarray],
                 max_frames: int = CACHE_FRAMES) -> np.ndarray:
    """Decoded-frame LRU: stride-1 length-L windows read every frame L
    times; caching kills (L-1)/L of the JPEG decodes. ``decode`` must
    return the uint8 image; frames are cached as uint8 (4x less host RAM
    than float32) and converted to float32/255 on every access (a ~ms
    conversion vs a ~10 ms decode). A hit is re-inserted at the back of
    the dict so eviction order is true LRU, not FIFO. Thread-safe under
    the decode pool: two threads racing on the same key decode twice,
    and eviction tolerates a concurrently-removed key."""
    # pop+reinsert refreshes recency; the default tolerates a racing evict
    hit = cache.pop(key, None)
    if hit is None:
        hit = decode()
        if len(cache) >= max_frames:
            try:
                cache.pop(next(iter(cache)), None)
            except (StopIteration, RuntimeError):
                pass                 # another thread mutated it — fine
    cache[key] = hit
    return np.asarray(hit, np.float32) / 255.0


# One shared daemon pool for every BatchLoader (loaders are constructed
# per epoch — a pool per loader would leak threads).
_DECODE_POOL: ThreadPoolExecutor | None = None
_DECODE_POOL_LOCK = threading.Lock()


def decode_pool(threads: int) -> ThreadPoolExecutor:
    """Shared pool, grown on demand: a later loader asking for MORE
    threads than the pool was created with gets a bigger pool; asking for
    fewer reuses the existing one. The old pool is NOT shut down — a
    still-live loader that grabbed it earlier keeps submitting to it (a
    shutdown here would raise 'cannot schedule new futures' on its next
    batch); dropping the global reference lets its worker threads exit
    once the last loader holding it is collected (the executor's weakref
    wake-up). The check-then-set runs under a lock: loaders resolve the
    pool from their prefetch worker threads, and two concurrent loaders
    racing here would otherwise both construct executors (one stranding
    its worker threads until GC)."""
    global _DECODE_POOL
    with _DECODE_POOL_LOCK:
        if _DECODE_POOL is None or threads > _DECODE_POOL._max_workers:
            _DECODE_POOL = ThreadPoolExecutor(
                max_workers=threads, thread_name_prefix="tcsfm-decode")
        return _DECODE_POOL
