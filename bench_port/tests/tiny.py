"""Small sizes of the declared cells for the CPU tests: each configuration
and traffic mix file gives its own under ``cpu_test`` (widths cut so that a
run takes seconds on the CPU)."""

from bench_port import spec

CELLS = tuple(w["name"] for w in spec.benchmark()["workloads"])


def overrides(cell_name: str) -> dict:
    cell = spec.cell(cell_name)
    return {"cfg_over": spec.config(cell["config"])["cpu_test"],
            "mix_over": spec.traffic(cell["traffic"])["cpu_test"]}
