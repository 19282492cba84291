"""Learning-rate schedule matching the reference exactly (the port's copy of
the JAX package's ``train/schedule.py``).

The reference updates Adam's lr at the END of every epoch divisible by 100
(train_model_set.py:585-590):  lr <- lr_min + lr0 * 0.1^(epoch / decay).
So epoch 0 trains at lr0; epochs u+1..u+100 (u = last update epoch) train at
lr_min + lr0 * 0.1^(u / decay).
"""

from __future__ import annotations

from .. import defaults


def step_lr(
    epoch: int,
    lr0: float,
    lr_min: float,
    decay: float,
    base: float = defaults.LEARNING_RATE_BASE,
    update_freq: int = defaults.LEARNING_RATE_UPDATE_FREQ,
) -> float:
    """lr used while *training* epoch `epoch` (0-based)."""
    if epoch == 0:
        return lr0
    last_update = ((epoch - 1) // update_freq) * update_freq
    return lr_min + lr0 * base ** (last_update / decay)
