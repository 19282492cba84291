#!/usr/bin/env python3
"""Where ``sort_rows``' cluster and radix paths spend their time, and the
kernel's times beside other checkouts' on one card:
``python3 profile_sort_rows.py [--roots DIR ...]`` (one NVIDIA card; exits
non-zero without one).

At the cluster path's shapes (8,192 rows of 32,896 with 16 payload rows, a
k=8 query block; 512 rows of 32,896 and of 131,072 with one, the
shared-vocab sorts at k=8 and k=9), on seeded random keys:

1. a phase breakdown: ``csrc/sort_rows.cu`` built again with a clock64
   counter after every barrier of the cluster kernel (thread 0 of each
   block adds the cycles since its last mark), one launch each; prints each
   phase's share of the summed cycles and the launch's time;
2. the radix path's breakdown at its shapes (RADIX_SHAPES: a k = 10
   genome's refresh sort, 512 rows of 262,144, a k = 10 query block, 1,024
   rows of 524,800 with 16 payload rows, and fsw_k10.train_lazy's refresh
   sort, 512 rows of 646,000): each of its 6 launches (the histogram of all
   four digits, the scan, and the downsweeps of 4 passes) alone through
   ``sort_rows_radix_step``, with CUDA events between them, the mean of
   RADIX_REPS sorts after a warm-up, with the bytes each launch moves and
   its rate, beside one ``sort_rows`` call;
3. with ``--roots``, the kernel's time at all these shapes in each
   checkout, in the order given (one process each, its own build; pass
   the parent and this checkout as ``P . . P`` to time them in turns),
   with CUDA events over REPS launches after a warm-up.

Prints one JSON line per result, then the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess
import sys

SHAPES = ((8192, 32896, 16), (512, 32896, 1), (512, 131072, 1))
RADIX_SHAPES = ((512, 262_144, 1), (1024, 524_800, 16), (512, 646_000, 1))
REPS = {8192: 5, 512: 30, 1024: 3}
RADIX_REPS = 5
# the radix path's launches in order (sort_rows_radix_step's steps)
RADIX_LAUNCHES = ("histogram", "scan") + tuple(f"pass {p} downsweep" for p in range(4))
SEED = 20261016
MARK = ("#define MARK(k) do { if (threadIdx.x == 0) { long long now_ = clock64(); "
        "atomicAdd(&g_phase[k], (unsigned long long)(now_ - t_prev)); t_prev = now_; } } while (0)\n")
# a mark after each barrier of the cluster kernel's pass, in order
PHASES = ("read back + count", "group scan", "publish + cluster barrier 1",
          "peer totals + digit scan", "digit offsets", "offsets added", "scatter",
          "cluster barrier 2")


def instrumented_source(src: str) -> str:
    """The kernel source with a mark after every barrier of the cluster
    kernel's pass loop and before its output, and a C entry point that
    resets or reads the counters."""
    start = src.index("sort_rows_cluster_kernel(const float*")
    end = src.index("cudaError_t launch_tile(")
    body = src[start:end]
    body = body.replace("  uint32_t* wcount = s.counts", "  long long t_prev = clock64();\n"
                        "  uint32_t* wcount = s.counts", 1)
    loop = body.index("for (int shift = 0;")
    head, tail = body[:loop], body[loop:]
    out, mark = [], 0
    for line in tail.split("\n"):
        if line.strip() == "cluster.sync();" and mark == 6:  # the scatter ends here
            out.append(f"    MARK({mark});")
            mark += 1
        out.append(line)
        if line.strip() in ("__syncthreads();", "cluster.sync();") and mark < len(PHASES):
            out.append(f"    MARK({mark});")
            mark += 1
    if mark != len(PHASES):
        raise RuntimeError(f"found {mark} of the {len(PHASES)} marks: the kernel has changed")
    body = head + "\n".join(out)
    close = body.rindex("\n}\n")  # the kernel's end: the output written
    body = body[:close] + f"\n  MARK({mark});" + body[close:]
    src = src[:start] + body + src[end:]
    kernel = src.rindex("template <", 0, src.index("sort_rows_cluster_kernel(const float*"))
    src = src[:kernel] + "__device__ unsigned long long g_phase[16];\n" + MARK + src[kernel:]
    return src.replace('extern "C" {', '''extern "C" {
int sort_rows_phases(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long zero[16] = {0};
    return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));
}
''', 1)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def inputs(torch, shape):
    r, n, p = shape
    gen = torch.Generator(device="cuda").manual_seed(SEED + n)
    return (torch.randn(r, n, generator=gen, device="cuda"),
            torch.rand(p, n, generator=gen, device="cuda"))


def breakdown() -> None:
    import torch

    from kf2vecfsw_tpu_torch.kernels import build, sort

    src = (build.CSRC_DIR / "sort_rows.cu").read_text()
    out_dir = build.BUILD_DIR / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "sort_rows_phases.cu", out_dir / "libsort_rows_phases.so"
    cu.write_text(instrumented_source(src))
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = sort._lib()  # the real library's signatures, declared on the instrumented one
    phased = ctypes.CDLL(str(so))
    for name in ("sort_rows_launch", "sort_rows_error_string", "sort_rows_tile_elems",
                 "sort_rows_cluster_elems", "sort_rows_items_per_thread", "sort_rows_cluster_shape"):
        getattr(phased, name).argtypes = getattr(lib, name).argtypes
        getattr(phased, name).restype = getattr(lib, name).restype
    phased.sort_rows_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    phased.sort_rows_phases.restype = ctypes.c_int
    real = sort._lib
    sort._lib = lambda: phased
    try:
        _phase_shares(torch, sort, phased)
    finally:
        sort._lib = real


def _phase_shares(torch, sort, phased) -> None:
    counts = (ctypes.c_ulonglong * 16)()
    for shape in SHAPES:
        keys, payload = inputs(torch, shape)
        got = sort.sort_rows(keys, payload)
        ref = sort.sort_rows_reference(keys, payload)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"instrumented kernel != plain version at {shape}")
        phased.sort_rows_phases(counts, 1)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        sort.sort_rows(keys, payload)
        stop.record()
        stop.synchronize()
        phased.sort_rows_phases(counts, 0)
        total = sum(counts)
        shares = {name: counts[i] / total for i, name in enumerate(PHASES + ("output",))}
        print(json.dumps({"shape": f"R={shape[0]} x N={shape[1]}, P={shape[2]}",
                          "instrumented_ms": start.elapsed_time(stop),
                          "cluster": sort.cluster_shape(shape[1]), "phase_share": shares}),
              flush=True)


def radix_step_bytes(r: int, n: int, p: int, step: int) -> int:
    """Bytes one launch of the radix path moves at least: the histogram
    reads the keys; the scan touches each word of the counts once (it reads
    the histogram's counts, writes the digit starts and clears the look-back
    status); a downsweep reads keys and columns (the first pass the keys
    alone) and writes them (the last pass the keys, perm and the payload,
    and reads the payload rows)."""
    from kf2vecfsw_tpu_torch.kernels.sort import launch_buffers

    if step == 0:
        return 4 * r * n
    if step == 1:
        return 4 * math.prod(launch_buffers(r, n)["counts"][0])
    radix_pass = step - 2
    read = 4 * r * n if radix_pass == 0 else 8 * r * n
    write = 12 * r * n if radix_pass == 3 else 8 * r * n
    return read + write + (4 * p * n if radix_pass == 3 else 0)


def radix_breakdown() -> None:
    import torch

    from kf2vecfsw_tpu_torch.kernels import sort

    lib = sort._lib()
    for shape in RADIX_SHAPES:
        r, n, p = shape
        keys, payload = inputs(torch, shape)
        bufs = {name: torch.empty(size, dtype=dtype, device="cuda")
                for name, (size, dtype) in sort.launch_buffers(r, n).items()}
        ptrs = [keys.data_ptr(), payload.data_ptr()] + [t.data_ptr() for t in bufs.values()]
        stream = torch.cuda.current_stream().cuda_stream
        steps = len(RADIX_LAUNCHES)
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        total = [0.0] * steps
        for rep in range(RADIX_REPS + 1):  # the first is the warm-up
            marks[0].record()
            for i in range(steps):
                err = lib.sort_rows_radix_step(*ptrs, r, n, p, i, stream)
                if err != 0:
                    raise RuntimeError(f"radix step {i}: {lib.sort_rows_error_string(err).decode()}")
                marks[i + 1].record()
            torch.cuda.synchronize()
            if rep:
                total = [t + marks[i].elapsed_time(marks[i + 1]) for i, t in enumerate(total)]
        ref = sort.sort_rows_reference(keys, payload)
        if not all(torch.equal(a, b) for a, b in zip((bufs["keys"], bufs["payload"], bufs["perm"]), ref)):
            raise AssertionError(f"the radix steps != plain version at {shape}")
        launches = {}
        for i, t in enumerate(total):
            ms = t / RADIX_REPS
            moved = radix_step_bytes(r, n, p, i)
            launches[RADIX_LAUNCHES[i]] = {"ms": ms, "bytes": moved, "tb_per_s": moved / ms / 1e9}
        downsweeps = [v for k, v in launches.items() if k.endswith("downsweep")]
        print(json.dumps({
            "shape": f"R={r} x N={n}, P={p}", "launches": launches,
            "downsweeps": {"ms": sum(v["ms"] for v in downsweeps),
                           "tb_per_s": sum(v["bytes"] for v in downsweeps)
                           / sum(v["ms"] for v in downsweeps) / 1e9},
            "sum_ms": sum(v["ms"] for v in launches.values()),
            "sort_rows_ms": cuda_ms(torch, lambda: sort.sort_rows(keys, payload), RADIX_REPS)}),
            flush=True)
        del keys, payload, bufs, ref
        torch.cuda.empty_cache()


def time_here() -> None:
    """The current checkout's sort_rows at SHAPES and RADIX_SHAPES (run from
    its root)."""
    sys.path.insert(0, os.getcwd())  # ahead of this script's own directory
    import torch

    from kf2vecfsw_tpu_torch.kernels.sort import sort_rows

    for shape in SHAPES + RADIX_SHAPES:
        keys, payload = inputs(torch, shape)
        ms = cuda_ms(torch, lambda: sort_rows(keys, payload), REPS[shape[0]])
        print(json.dumps({"root": os.path.basename(os.getcwd()),
                          "shape": f"R={shape[0]} x N={shape[1]}, P={shape[2]}", "ms": ms}),
              flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--roots", nargs="*", default=[], help="checkouts to time in turns")
    parser.add_argument("--time-here", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_sort_rows: needs a CUDA card", file=sys.stderr)
        return 1
    if args.time_here:
        time_here()
        return 0
    breakdown()
    radix_breakdown()
    for root in args.roots:
        root = os.path.abspath(root)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time-here"], cwd=root,
                       env={**os.environ, "PYTHONPATH": root}, check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
