"""Host and device time of one ``topk_select`` call at the main path's shape.

The retrieval front end ranks each query's float64 BM25 scores of a
65536-document shard with one ``topk_select(scores, 64)`` call, and the
host thread waits on every query, so the call's cost on the host counts
as much as its kernel's. This script times both for the ``repro_torch``
package under ``--src`` (default: the tree it lives in), so that two
trees can be compared on one card, one process each:

    python3 src/repro_torch/launch/time_topk.py [--src OTHER/src]

It prints one JSON line:

* ``host_us``: the mean and median wall time of the Python call (the
  wrapper, its allocations and the launch) with the card's queue empty
  before each call;
* ``enqueue_us``: the mean wall time a call of ``iters`` issued back to
  back, then one synchronisation;
* ``kernel_ms``: the device time of one call, with the card's queue
  kept full: a spin kernel holds the card while ``DEVICE_CALLS`` calls
  are issued behind it, and CUDA events around the calls divide by
  their number (no L2 flush: the scores stay in L2 as they do after
  BM25 wrote them).

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

N_DOCS = 65536
TOP_K = 64
DEVICE_CALLS = 200
SPIN_CYCLES = 50_000_000     # ~25 ms at 2 GHz, longer than the issuing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from repro_torch.kernels.topk_select import topk_select
    if not torch.cuda.is_available():
        print("time_topk: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    scores = torch.randn(N_DOCS, generator=gen, device=dev,
                         dtype=torch.float64)
    for _ in range(100):                      # build, load, warm up
        topk_select(scores, TOP_K)
    torch.cuda.synchronize()

    host = []
    for _ in range(args.iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        topk_select(scores, TOP_K)
        host.append(time.perf_counter() - t0)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(args.iters):
        topk_select(scores, TOP_K)
    torch.cuda.synchronize()
    enqueue = (time.perf_counter() - t0) / args.iters

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    device_ms = []
    for _ in range(5):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(DEVICE_CALLS):
            topk_select(scores, TOP_K)
        end.record()
        if start.query():
            raise RuntimeError("the spin kernel ended before the calls "
                               "were issued; raise SPIN_CYCLES")
        end.synchronize()
        device_ms.append(start.elapsed_time(end) / DEVICE_CALLS)

    print(json.dumps({
        "src": str(Path(args.src).resolve()),
        "card": torch.cuda.get_device_name(0),
        "shape": f"float64 N {N_DOCS}, k {TOP_K}",
        "iters": args.iters,
        "host_us": {"mean": statistics.fmean(host) * 1e6,
                    "median": statistics.median(host) * 1e6},
        "enqueue_us": enqueue * 1e6,
        "kernel_ms": statistics.median(device_ms),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
