"""The shared exact coefficient kernel's share of its roofline over the
traced window: the least time of the coefficients the program counted in
the window (``counts_coefficients.shared_least_s`` of
``fsw.exact.coefficients.forward`` and ``.backward``, recomputes included)
over the traced device time of ``exact_shared_kernel``, forward and
backward. Its cells take the shared route, whose coefficients that kernel
alone computes. None where the counters or the kernel's time are absent (a
program that does not count them, an untraced or CPU run)."""

from bench_port import counts_coefficients

KERNELS = ("exact_shared_kernel",)
FORWARD, BACKWARD = "fsw.exact.coefficients.forward", "fsw.exact.coefficients.backward"


def read(r):
    counters = r.run.records.get("counters", {})
    forward, backward = counters.get(FORWARD), counters.get(BACKWARD)
    if r.trace is None or not forward or not backward:
        return None
    device_s = r.trace.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * counts_coefficients.shared_least_s(forward, backward) / device_s
