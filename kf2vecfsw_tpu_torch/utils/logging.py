"""Per-run file+stream loggers, mirroring the reference's operator experience
(timestamped log file in the output dir, message-only format; e.g.
train_model_set.py:114-130)."""

from __future__ import annotations

import itertools
import logging
import os
import time

_counter = itertools.count()


def make_run_logger(out_dir: str, filename: str) -> logging.Logger:
    log = logging.getLogger(f"kf2vec_torch.run{next(_counter)}")
    log.setLevel(logging.INFO)
    log.propagate = False
    fmt = logging.Formatter("%(message)s")
    os.makedirs(out_dir, exist_ok=True)
    fh = logging.FileHandler(os.path.join(out_dir, filename), "w+")
    fh.setFormatter(fmt)
    log.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    log.addHandler(sh)
    return log


def close_logger(log: logging.Logger) -> None:
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()


def timestamp() -> str:
    return time.strftime("%Y%m%d_%H%M%S")
