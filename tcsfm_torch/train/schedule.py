"""Learning-rate schedule: halve every ``lr_decay_epoch`` epochs
(counterpart of ``tcsfm/train/schedule.py``).

lr(step) = base * 0.5^(epoch // decay) with epoch = step // steps_per_epoch,
the step-based form of the reference's exp_lr_scheduler.
"""

from __future__ import annotations

from typing import Callable


def halving_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (0.5 ** (epoch // max(decay_epochs, 1)))

    return schedule
