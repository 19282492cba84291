"""The per-genome lazy refreshes' share of their least time over the traced
window: ``counts_pergenome.refresh_least_s`` of the real points the
program counted (``fsw.refresh.points``, ``train/fsw_lazy.py``
``LazyPlanes``) over the host seconds of the benchmark's ``refresh`` span,
which has a synchronise at both ends. The least time is that of the work,
whatever implements it. On the CPU there is no card whose peaks it would be
a share of: None."""

from bench_port import counts_pergenome


def read(r):
    points = r.run.records.get("counters", {}).get("fsw.refresh.points")
    host_s = r.tracer.host_s.get("refresh", 0.0)
    if not points or host_s <= 0 or r.run.dev.type != "cuda":
        return None
    return share(r.run.cfg, points, host_s)


def share(cfg: dict, points: int, host_s: float) -> float:
    return 100.0 * counts_pergenome.refresh_least_s(cfg, points) / host_s
