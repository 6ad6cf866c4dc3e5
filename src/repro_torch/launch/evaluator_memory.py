"""Peak device memory of one full-width evaluator call, by row count.

The fused drain runs its evaluator on ``max_evals`` rows of every
micro-batch (all of the batch's 4096 when no cap is set), so the
largest cap that fits on the card is the largest row count whose
evaluator call fits beside the weights. For each ``--arch`` this script
builds the evaluator at its published width on the card (seeded
weights), then calls ``evaluate`` on ``rows`` documents of the
evaluator's own features for each row count of ``--rows`` (one warm-up
call, then a measured one), and prints one JSON line per call:

    python3 src/repro_torch/launch/evaluator_memory.py \\
        [--arch qwen3-moe-30b-a3b ...] [--rows 1024 2048 3072 4096]

``weights_gib`` is the memory the evaluator holds, ``peak_gib`` the
most allocated during the measured call (weights included), ``ms`` its
wall time with the card synchronised before and after. A call that
runs out of memory prints ``"oom": true``, and the larger row counts of
that arch are skipped.

Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ARCHS = ("qwen2.5-14b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", nargs="+", default=list(ARCHS))
    ap.add_argument("--rows", nargs="+", type=int,
                    default=[1024, 2048, 3072, 4096])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch
    from repro_torch.serving.evaluators import make_evaluator
    if not torch.cuda.is_available():
        print("evaluator_memory: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gib = 2 ** 30
    for arch in args.arch:
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        evaluate, mk = make_evaluator(arch, smoke=False, seed=args.seed,
                                      device=dev)
        torch.cuda.synchronize()
        weights = torch.cuda.memory_allocated() - base
        for rows in sorted(args.rows):
            chunk = {k: torch.from_numpy(v).to(dev)
                     for k, v in mk(rows, fseed=rows).items()}
            line = {"arch": arch, "rows": rows, "weights_gib": weights / gib}
            try:
                evaluate(chunk)                            # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.monotonic()
                scores = evaluate(chunk)
                torch.cuda.synchronize()
                line.update(ms=(time.monotonic() - t0) * 1e3,
                            peak_gib=torch.cuda.max_memory_allocated() / gib,
                            finite=bool(torch.isfinite(scores).all()),
                            oom=False)
                del scores
            except torch.cuda.OutOfMemoryError:
                line.update(oom=True)
            del chunk
            gc.collect()
            torch.cuda.empty_cache()
            print(json.dumps(line), flush=True)
            if line["oom"]:
                break
        del evaluate, mk
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
