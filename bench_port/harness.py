"""One run of one cell: set-up, the measured window, the comparison, the
result line.

``run_cell`` is what ``run.py`` calls once it has found the card; the CPU
tests call it with ``device="cpu"`` and small sizes, which is the only way
it runs without a card.
"""

from __future__ import annotations

import sys
import time

import torch

from . import compare, spec
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "kf2vecfsw_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


class Readings:
    """What a per-layer metric's reader reads: the run's driver (its config,
    records and ``flops``), the tracer's host spans and recorded shapes, and
    the reduced device trace (None in an untraced run)."""

    def __init__(self, run, tracer: Tracer):
        self.run = run
        self.tracer = tracer
        self.trace = tracer.reduced


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             started: float | None = None, cfg_over: dict | None = None,
             mix_over: dict | None = None) -> dict:
    """The result object of one run. ``started`` is the process's start on
    the host clock (set-up counts from it); ``cfg_over`` and ``mix_over``
    replace entries of the configuration and the mix (the CPU tests' small
    sizes)."""
    started = time.perf_counter() if started is None else started
    cell = spec.cell(cell_name)
    cfg = {**spec.config(cell["config"]), **(cfg_over or {})}
    mix = {**spec.traffic(cell["traffic"]), **(mix_over or {})}
    limits = spec.limits(cell_name)
    dev = torch.device(device)
    tracer = Tracer(trace, dev)
    run = spec.driver(mix["driver"]).Run(cfg, mix, seed, dev, tracer)
    try:
        run.setup()
        setup_s = time.perf_counter() - started
        run.window(seconds)
        peak = run.memory_peak()
        e2e = run.end_to_end()
        attempted, failed = run.attempted_failed()
        run.release()
        numbers = run.numbers()
    finally:
        run.close()
    ok, checks = compare.verdict(numbers, limits)
    e2e["setup_s"] = setup_s
    if trace:
        readings = Readings(run, tracer)
        values = {}
        for m in spec.metrics_of(cell_name, "per_layer"):
            v = spec.metric_reader(m["name"])(readings)
            if v is not None:
                values[m["name"]] = (v, m["unit"])
    else:
        values = {m["name"]: (e2e[m["name"]], m["unit"])
                  for m in spec.metrics_of(cell_name, "end_to_end")}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and failed == 0), "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
              "device": device_info}
    if trace and tracer.reduced is not None:
        device_info.update(busy_s=tracer.reduced.busy_s, window_s=tracer.reduced.window_s)
        result["breakdown"] = tracer.reduced.breakdown()
    result["checks"] = checks
    return result

