"""Device time of one ``shed_partition`` call, taken apart.

The fused drain calls ``shed_partition`` once per micro-batch (N 4096 in
the fused drain, 3072 in the serving engine) on the production Trust DB
(65536 sets x 4 ways, ways-leading), which arrives cold: the evaluator's
traffic evicts it from L2 between batches. This script times the kernel
of the ``repro_torch`` package under ``--src`` (default: the tree it
lives in) on inputs made as ``chip_smoke.py`` makes them, so that two
trees can be compared on one card, one process each:

    python3 src/repro_torch/launch/time_shed.py [--src OTHER/src]

Each case is the mean of ``--iters`` calls, CUDA events around each, L2
flushed by a 1 GiB write between calls; a ``warm`` case spins the card
instead (the events then time the kernel, not the host's launch), and
its inputs and Trust DB stay in L2:

* ``n4096``, ``n3072``: the main path's batches, 90% valid, half the
  valid keys cached;
* ``n4096_warm``: the same with the inputs and the Trust DB in L2;
* ``n4096_all_miss``: no key cached, so no value is loaded;
* ``n4096_no_probe`` (and ``_warm``): every flag false, so nothing is
  probed: loads of keys and flags, the scan and the stores only;
* ``n4096_slots_leading``: the legacy layout, whose four ways share one
  16-byte run, so a probe touches one cache line instead of four;
* ``n1024``, ``n512``: smaller batches, to tell what grows with N from
  what does not;
* ``n1``: one valid cached key: the chain of dependent round trips with
  no throughput to speak of; ``n0``: the launch alone.

It prints one JSON line with the card and each case's milliseconds.
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SLOTS, WAYS = 65536, 4           # TrustIRConfig.cache_slots, cache_ways
UCAP, UTHR = 2048, 1024          # TrustIRConfig.u_capacity, u_threshold
BUDGET = 2048
SPIN_CYCLES = 600_000            # ~0.3 ms, as long as the 1 GiB write


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from repro_torch.core import trust_cache as TC
    from repro_torch.kernels.shed_partition import shed_partition
    if not torch.cuda.is_available():
        print("time_shed: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    state = TC.init(SLOTS, WAYS, device=dev)
    cached = []
    while float(TC.occupancy(state)) < 0.5:   # about half full
        keys = torch.randint(1, 2 ** 31 - 1, (40_000,), generator=gen,
                             device=dev, dtype=torch.int32)
        state = TC.insert(state, keys, torch.rand(keys.shape, generator=gen,
                                                  device=dev) * 5,
                          torch.ones_like(keys, dtype=torch.bool))
        cached.append(keys)
    cached = torch.cat(cached)
    ck, cv = state["keys"], state["values"]
    legacy = (ck.T.contiguous(), cv.T.contiguous())

    def batch(n, hit_share=0.5, valid_share=0.9):
        pick = torch.randint(0, cached.shape[0], (n,), generator=gen,
                             device=dev)
        fresh = torch.randint(1, 2 ** 31 - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        keys = torch.where(torch.rand(n, generator=gen, device=dev)
                           < hit_share, cached[pick], fresh)
        valid = torch.arange(n, device=dev) < int(n * valid_share)
        return keys, valid

    cases = {
        "n4096": (batch(4096), (ck, cv), True),
        "n3072": (batch(3072), (ck, cv), True),
        "n4096_warm": (batch(4096), (ck, cv), False),
        "n4096_all_miss": (batch(4096, hit_share=0.0), (ck, cv), True),
        "n4096_no_probe": (batch(4096, valid_share=0.0), (ck, cv), True),
        "n4096_no_probe_warm": (batch(4096, valid_share=0.0), (ck, cv),
                                False),
        "n4096_slots_leading": (batch(4096), legacy, True),
        "n1024": (batch(1024), (ck, cv), True),
        "n512": (batch(512), (ck, cv), True),
        "n1": (batch(1, hit_share=1.0, valid_share=1.0), (ck, cv), True),
        "n0": (batch(0), (ck, cv), True),
    }
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    ms = {}
    for name, ((keys, valid), (k, v), flush) in cases.items():
        def call():
            shed_partition(keys, valid, k, v, UCAP, UTHR, BUDGET,
                           budget_is_total=True)
        call()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(args.iters):
            if flush:
                scratch.zero_()
            else:
                torch.cuda._sleep(SPIN_CYCLES)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            call()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        ms[name] = float(np.mean([a.elapsed_time(b) for a, b in pairs]))

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": str(Path(args.src).resolve()), "card": card,
                      "iters": args.iters, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
