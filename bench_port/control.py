#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card:

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 [--seconds 3] [--fault NAME]

For each seed, one set-up of the cell (a training cell's checked steps;
where the driver's comparison reads its window, ``CHECKS_A_WINDOW``, also
a short window of ``--seconds``), then the
comparison's numbers of the program against the reference ("program")
and of the control against it ("control"): the reference in the program's
place with TF32 products, the precision below the configurations'
float32. With ``--fault`` the program runs with that fault of
``faults.py`` planted. Prints one JSON line per seed; all seeds run in one
process, so the set-up's one-time costs are paid once. Not part of a
benchmark run.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def readings(cell_name: str, seed: int, seconds: float, device: str = "cuda",
             fault: str | None = None, cfg_over: dict | None = None,
             mix_over: dict | None = None) -> dict:
    import torch

    from bench_port import faults, spec
    from bench_port.trace import Tracer

    cell = spec.cell(cell_name)
    cfg = {**spec.config(cell["config"]), **(cfg_over or {})}
    mix = {**spec.traffic(cell["traffic"]), **(mix_over or {})}
    dev = torch.device(device)
    run = spec.driver(mix["driver"]).Run(cfg, mix, seed, dev, Tracer(False, dev))
    try:
        with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
            run.setup()
            if run.CHECKS_A_WINDOW:
                run.window(seconds)
        run.release()
        out = {"seed": seed, "fault": fault, "program": run.numbers(),
               "control": run.control_numbers()}
        if hasattr(run, "leaf_readings"):
            out["leaves"] = run.leaf_readings()
        return out
    finally:
        run.close()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import gc

    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.seconds, fault=args.fault)),
              flush=True)
        gc.collect()  # a run's driver holds reference cycles: free its device memory now
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
