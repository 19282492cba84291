"""The share of the traced window spent in the lazy route's refreshes
(``LazyPlanes.refresh``), timed by the benchmark's span around the call
with a synchronise at both ends."""


def read(r):
    if r.trace is None or r.run.records.get("refreshes", 0) == 0:
        return None
    return 100.0 * r.tracer.host_s["refresh"] / r.trace.window_s
