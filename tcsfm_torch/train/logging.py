"""Metric and image logging (counterpart of ``tcsfm/train/logging.py``).

Scalars always go to ``scalars.jsonl`` in the log directory, one JSON
object a line (``tag``, ``value``, ``step``, ``ts``), so a run's numbers
can be read without TensorBoard; where ``torch.utils.tensorboard`` imports
they go to its event files too. Images go to TensorBoard where it imports,
else to ``<tag>_<step>.png`` through PIL; where neither is there,
``add_image`` raises the ``ImportError`` that names what is missing.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, log_dir: str, comment: str = ""):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=log_dir, comment=comment)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": step, "ts": time.time()})
                          + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_image(self, tag: str, img: np.ndarray, step: int) -> None:
        """img: [H, W, 3] uint8."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
            return
        from PIL import Image

        safe = tag.replace("/", "_")
        Image.fromarray(img).save(os.path.join(self.log_dir,
                                               f"{safe}_{step}.png"))

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
