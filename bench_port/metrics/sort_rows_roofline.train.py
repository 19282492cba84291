"""``sort_rows``' share of its roofline over the traced window: the least
time of every launch (``counts.sort_rows_bound_s`` of the shape the
benchmark's wrapper recorded) over the device time of its kernels."""

from bench_port import counts

KERNELS = ("sort_rows_tile_kernel", "sort_rows_cluster_kernel", "presort_tiles_kernel",
           "merge_global_kernel", "merge_tiles_kernel", "radix_upsweep_kernel",
           "radix_scan_kernel", "radix_downsweep_kernel")


def read(r):
    launches = r.tracer.records.get("sort_rows")
    if r.trace is None or not launches:
        return None
    device_s = r.trace.kernel_s(KERNELS)
    if device_s <= 0:
        return None
    return 100.0 * sum(counts.sort_rows_bound_s(*shape) for shape in launches) / device_s
