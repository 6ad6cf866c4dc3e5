#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration and traffic; ``portbench/harness.py`` does the run. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, then the readings and, last, every compared number beside
its limit); the compared numbers are also the last lines of standard
error. Exits with 2, printing no result, without an NVIDIA GPU or with
fewer than the cell asks for.

``--control 1`` also reads the float8 control's trust gap on the items
the check judges (to set the cell's limit; the benchmark's runs do not).
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def power_limit_w():
    """The card's power limit from ``nvidia-smi`` (None if unreadable)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())

    import torch

    from portbench import harness

    files = harness.cell_files(manifest, args.workload)
    chips = int(files["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} NVIDIA GPU(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": power_limit_w()}
    line = harness.run(files, args.seed, args.seconds, bool(args.trace),
                       device, T_START, info, control=bool(args.control))
    for key, val in line["readings"].items():
        print(f"reading {key}: {val}", file=sys.stderr)
    for key, c in line["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
