#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``kf2vecfsw_tpu_torch``) on one
NVIDIA card, one cell a run:

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It needs the card (``torch.cuda``) and exits non-zero without it, or
without the port beside it. It makes every input from the seed, warms the
cell's shapes up (set-up), measures the window, compares what the window
produced with the plain reference in ``reference/`` (``correct``), and
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
a ``breakdown`` of the device's time and idle gaps, and last ``checks``,
each compared number beside its limit (also the last lines of standard
error). Nothing it runs imports JAX or the JAX package; a run that finds
one loaded exits non-zero. ``README.md`` says how to add a configuration,
a traffic mix, a cell or a per-layer metric.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# caches at fixed paths inside the checkout, so that only a cell's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(HERE / "cache" / sub)
sys.path.insert(0, str(HERE.parent))

THREADS = 4  # host threads of torch's CPU ops: one steady process


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port import harness, spec

    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(THREADS)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"bench_port: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
