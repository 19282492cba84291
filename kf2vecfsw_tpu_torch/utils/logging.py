"""Per-run file+stream loggers, mirroring the reference's operator experience
(timestamped log file in the output dir, message-only format; e.g.
train_model_set.py:114-130). Over ranks only the coordinator opens the
file (and makes the output directory); every rank logs to its stream."""

from __future__ import annotations

import itertools
import logging
import os
import time

from ..parallel.mesh import is_coordinator
from .cancel import Cancelled, CancelFlag, writing

_counter = itertools.count()


class _GuardedFileHandler(logging.FileHandler):
    """A log file whose records are written under a request's cancel flag:
    once the watchdog cancelled the request, records are dropped."""

    def __init__(self, path: str, cancel: CancelFlag | None):
        self.cancel = cancel
        with writing(cancel, path):
            super().__init__(path, "w+")

    def emit(self, record: logging.LogRecord) -> None:
        try:
            with writing(self.cancel, self.baseFilename):
                super().emit(record)  # flushes
        except Cancelled:
            pass


def make_run_logger(out_dir: str, filename: str, cancel: CancelFlag | None = None) -> logging.Logger:
    log = logging.getLogger(f"kf2vec_torch.run{next(_counter)}")
    log.setLevel(logging.INFO)
    log.propagate = False
    fmt = logging.Formatter("%(message)s")
    if is_coordinator():
        os.makedirs(out_dir, exist_ok=True)
        fh = _GuardedFileHandler(os.path.join(out_dir, filename), cancel)
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
