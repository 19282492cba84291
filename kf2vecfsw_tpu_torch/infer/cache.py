"""Device-resident serving caches for checkpoints, backbone anchors and query
features (the port's copy of the JAX package's ``infer/cache.py``).

A one-shot ``process_query_data`` reads every model from disk, builds it and
ships it to the card; a serving process keeps them there. Entries are keyed
by the file's real path and the device (a CPU entry and a card entry never
meet) and invalidated by (mtime_ns, size), so a retrained subtree model is
picked up on the next call. Eviction is byte-aware LRU under 1/4 of the
device's memory (``utils/membudget``, ``KF2VEC_HBM_BYTES`` overrides), so a
library of hundreds of subtrees cannot hold more than that.

Unlike the JAX package, anchor rows are not padded to a bucket: that padding
bounded XLA's compilations, and nothing here compiles per shape.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Any, Callable

import numpy as np
import torch

from .. import defaults
from ..utils import phases
from ..utils.membudget import hbm_fraction


def serving_cache_budget_bytes(device: str) -> int:
    return hbm_fraction(1, 4, device)


def _value_bytes(value: Any) -> int:
    """Bytes of the arrays in a cached value: a module's parameters, tensors
    and numpy arrays, inside tuples and lists."""
    if isinstance(value, torch.nn.Module):
        return sum(p.numel() * p.element_size() for p in value.parameters())
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (tuple, list)):
        return sum(_value_bytes(v) for v in value)
    return 0


class DeviceFileCache:
    """Byte-budget LRU of values derived from files, per device.
    ``budget_bytes(device)`` bounds the bytes held for one device."""

    def __init__(self, budget_bytes: Callable[[str], int] = serving_cache_budget_bytes):
        self._budget_bytes = budget_bytes
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple[str, str], tuple[tuple[int, int], int, Any]] = OrderedDict()
        self._bytes: dict[str, int] = {}
        self.hits = 0
        self.misses = 0

    def get(self, path: str, build: Callable[[], Any], device: str | torch.device = "cpu") -> Any:
        dev = str(device)
        key = (os.path.realpath(path), dev)
        st = os.stat(key[0])
        sig = (st.st_mtime_ns, st.st_size)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None and hit[0] == sig:
                self._entries.move_to_end(key)
                self.hits += 1
                return hit[2]
        # build outside the lock: loading a 76 MB model must not hold up
        # unrelated lookups
        value = build()
        nbytes = _value_bytes(value)
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes[dev] -= old[1]
            self.misses += 1
            budget = self._budget_bytes(dev)
            if nbytes <= budget:
                self._entries[key] = (sig, nbytes, value)
                self._bytes[dev] = self._bytes.get(dev, 0) + nbytes
                while self._bytes[dev] > budget:  # the new entry fits alone
                    victim = next(k for k in self._entries if k[1] == dev)
                    self._bytes[dev] -= self._entries.pop(victim)[1]
        return value

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()

    @property
    def nbytes(self) -> int:
        return sum(self._bytes.values())

    def __len__(self) -> int:
        return len(self._entries)


_checkpoints = DeviceFileCache()
_anchors = DeviceFileCache()


def cached_checkpoint(path: str, device: torch.device) -> tuple[str, dict, torch.nn.Module]:
    """(model_name, meta, module): the checkpoint's model on ``device`` in
    eval mode, LRU-cached by file."""

    def build():
        from ..models.mlp import params_from_jax
        from ..train.checkpoint import load_checkpoint

        model_name, meta, params = load_checkpoint(path)
        module = params_from_jax(params).to(device).eval()
        return model_name, meta, module.requires_grad_(False)

    return _checkpoints.get(path, build, device)


def cached_embeddings(path: str, device: torch.device) -> tuple[list[str], torch.Tensor]:
    """Backbone embeddings CSV -> (names, float32 (anchors, E) tensor on
    ``device``), LRU-cached by file."""

    def build():
        from .query import read_embeddings_csv

        names, emb = read_embeddings_csv(path)
        return names, torch.from_numpy(np.ascontiguousarray(emb)).to(device)

    return _anchors.get(path, build, device)


def _kf_cache_budget(device: str) -> int:
    return int(os.environ.get("KF2VEC_KF_CACHE_BYTES", 512 << 20))


_kf_rows = DeviceFileCache(budget_bytes=_kf_cache_budget)


def read_kf_files_cached(paths: list[str], dtype=np.float32) -> tuple[list[str], np.ndarray]:
    """read_kf_files with a host-RAM LRU of parsed rows (512 MiB by default,
    KF2VEC_KF_CACHE_BYTES to override). A placement parses its query `.kf`
    files twice (classify, then query); the second pass is a stat and a
    vstack."""
    from ..io.kf import read_kf

    all_names: list[str] = []
    mats: list[np.ndarray] = []
    for p in paths:
        names, mat = _kf_rows.get(p, lambda p=p: read_kf(p, dtype=np.float32), "host")
        all_names.extend(names)
        if mat.size:
            mats.append(mat)
    if not mats:
        return all_names, np.zeros((0, 0), dtype=dtype)
    return all_names, np.vstack(mats).astype(dtype, copy=False)


# -- shared device-resident query feature matrix --------------------------------
#
# classify and query read the SAME query rows (classify once, query once per
# clade). The whole scaled (rows, V) matrix is kept on the device once per
# query-file set; classify slices row blocks from it and query gathers each
# clade's rows by index, so the features cross to the card once. Keyed by the
# device and the ordered (realpath, mtime_ns, size) of every file, so a
# rewritten query file invalidates the set.


class QueryMatrixCache:
    """Tiny LRU (a serving process handles one query set at a time) of
    (row_names, {file_stem: (start, stop)}, device matrix)."""

    def __init__(self, max_entries: int = 2):
        self._max = max_entries
        self._lock = threading.Lock()
        self._entries: OrderedDict[tuple, tuple] = OrderedDict()

    def get(self, paths: list[str], device: torch.device):
        """None when disabled (KF2VEC_NO_QUERY_MATRIX), over budget, or the
        set is not cacheable."""
        if os.environ.get("KF2VEC_NO_QUERY_MATRIX"):
            return None
        try:
            key = (str(device),) + tuple(
                (os.path.realpath(p), st.st_mtime_ns, st.st_size)
                for p, st in ((p, os.stat(p)) for p in paths)
            )
        except OSError:
            return None
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                return hit
        value = self._build(paths, key[1:], device)
        if value is None:
            return None
        with self._lock:
            self._entries[key] = value
            while len(self._entries) > self._max:
                self._entries.popitem(last=False)
        return value

    def _build(self, paths: list[str], sigs: tuple, device: torch.device):
        from ..io.kf import read_kf

        budget = hbm_fraction(1, 8, device)
        # text is ~2.4x the f32 it parses to: a cheap gate before parsing
        if sum(sig[2] for sig in sigs) * 2 > budget:
            return None
        names: list[str] = []
        spans: dict[str, tuple[int, int]] = {}
        mats: list[np.ndarray] = []
        row = 0
        with phases.phase("parse"):
            for p in paths:
                stem = os.path.basename(p).removesuffix(".kf")
                f_names, mat = read_kf(p, dtype=np.float32)
                if mat.size and mats and mat.shape[1] != mats[0].shape[1]:
                    return None  # mixed widths: the per-block path reports the error
                names.extend(f_names)
                spans[stem] = (row, row + len(f_names))
                row += len(f_names)
                if mat.size:
                    mats.append(mat)
        if not mats:
            return None
        full = np.vstack(mats)
        if full.shape[0] != row:
            return None  # a file with names but no rows would desync spans
        if full.nbytes > budget:
            return None
        with phases.phase("transfer"):
            dev = torch.from_numpy(full * np.float32(defaults.FEATURES_SCALER)).to(device)
        return names, spans, dev

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_query_mats = QueryMatrixCache()


def cached_query_matrix(paths: list[str], device: torch.device):
    """(row_names, {stem: (start, stop)}, (rows, V) float32 matrix on
    ``device`` already scaled by FEATURES_SCALER), or None (then the caller
    reads block by block)."""
    return _query_mats.get([p for p in paths if p.endswith(".kf")], device)


def clear_query_data() -> None:
    """Drop parsed and transferred QUERY data; model checkpoints and anchors
    stay resident, as in a serving process."""
    _kf_rows.clear()
    _query_mats.clear()


def clear_all() -> None:
    _checkpoints.clear()
    _anchors.clear()
    _kf_rows.clear()
    _query_mats.clear()


def cache_stats() -> dict:
    """Hit/miss/residency counters of the serving caches (the serve daemon's
    ``stats`` reply: whether requests ride resident models)."""
    return {
        "checkpoints": {
            "hits": _checkpoints.hits,
            "misses": _checkpoints.misses,
            "entries": len(_checkpoints),
            "device_bytes": _checkpoints.nbytes,
        },
        "anchors": {
            "hits": _anchors.hits,
            "misses": _anchors.misses,
            "entries": len(_anchors),
            "device_bytes": _anchors.nbytes,
        },
        "kf_rows": {
            "hits": _kf_rows.hits,
            "misses": _kf_rows.misses,
            "entries": len(_kf_rows),
            "host_bytes": _kf_rows.nbytes,
        },
    }
