"""The bf16 instances of ``flash_attention``'s forward, side by side.

The forward has three bf16 instances (``kernels/flash_attention.py``,
``instance``): the ``mma.sync`` kernel with the GQA group packed into its
rows, the warp-specialised ``wgmma`` kernel that long sequences take
(``long_instance``), and the persistent TMA-fed kernel that the
evaluators' short sequences take (``short_instance``). This script holds
each instance a shape can run against the plain version and times each,
with and without the lse output, beside SDPA and the bound, at the shapes
given. The default shapes, by ``--set``: ``long`` smollm-135m's training
microbatch, the decode phase's longest prefill, a D 128 training row with
qwen2.5's heads, gemma2-2b's training microbatch (D 256, softcap 50), and
sweeps of prefill lengths that place ``LONG_FROM`` (smollm's heads,
qwen2.5's, and gemma2's local layer, S 128 to 8000 with its 4096-key
window); ``short`` the evaluators' S 31 (smollm at the fused drain's and
the engine's batches, qwen2.5-14b, qwen3-moe, moonshot at theirs), a B 1
sweep of S 1 to 64 at smollm's heads that places ``SHORT_TO``, and a
sweep of the batch at S 31; ``all`` (the default) both:

    python3 src/repro_torch/launch/time_attention.py
        [--set all|long|short] [--shape B,S,Hq,Hkv,D[,softcap[,window]] ...]
        [--no-check] [--iters N]

One JSON line a shape: the instance the rules pick, each instance's
``ms`` / ``lse_ms`` (forced through ``_forward``'s ``long_from`` and
``short_to``) and its max abs error against ``flash_attention_ref`` (in
chunks of batch rows), two calls equal bit for bit, SDPA's time, the
bound. CUDA-event means with a 1 GiB write between launches (L2 cold, as
on the main path). Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

SHAPE_SETS = {
    "long": ["8,4096,9,3,64", "1,1984,9,3,64", "2,4096,40,8,128",
             "1,128,9,3,64", "1,192,9,3,64", "1,256,9,3,64",
             "1,384,9,3,64", "1,512,9,3,64", "1,1024,9,3,64",
             "1,256,40,8,128", "1,512,40,8,128", "2,4096,8,4,256,50",
             *(f"1,{s},8,4,256,50,4096" for s in (
                 128, 192, 256, 512, 1024, 2048, 4096, 8000))],
    "short": ["4096,31,9,3,64", "3072,31,9,3,64", "4096,31,40,8,128",
              "2048,31,32,4,128", "3072,31,16,16,128",
              *(f"1,{s},9,3,64" for s in (1, 8, 16, 24, 31, 32, 33, 48,
                                          64)),
              *(f"{b},31,9,3,64" for b in (4, 16, 44, 88, 176, 512, 1024))],
}
SHAPE_SETS["all"] = SHAPE_SETS["long"] + SHAPE_SETS["short"]
# each instance forced: (long_from, short_to)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12


def timed_ms(call, iters: int, scratch) -> float:
    """Mean CUDA-event time of ``call`` over ``iters`` launches, with
    ``scratch`` (1 GiB on the card) zeroed between them: L2 cold."""
    import numpy as np
    import torch
    call()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        scratch.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--set", choices=sorted(SHAPE_SETS), default="all",
                    help="the default shapes (without --shape)")
    ap.add_argument("--shape", action="append",
                    help="B,S,Hq,Hkv,D[,softcap[,window]] (causal bf16); "
                         "repeatable")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    if not torch.cuda.is_available():
        print("time_attention: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    def timed(fn) -> float:
        return timed_ms(fn, args.iters, scratch)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for spec in args.shape or SHAPE_SETS[args.set]:
        B, S, Hq, Hkv, D, *extra = spec.split(",")
        B, S, Hq, Hkv, D = (int(x) for x in (B, S, Hq, Hkv, D))
        softcap = float(extra[0]) if extra else 0.0
        window = int(extra[1]) if len(extra) > 1 else 0
        kw = dict(causal=True, window=window, softcap=softcap)
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        scale = D ** -0.5
        flops, n_bytes = FA.cost(B, S, Hq, Hkv, D, 2, causal=True,
                                 window=window)
        G = Hq // Hkv
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, S {S}, {Hq}/{Hkv}, D {D}, bf16 causal, "
                        f"softcap {softcap}, window {window}",
               "instance": FA.instance(S, G, D, torch.bfloat16,
                                       window=window, softcap=softcap),
               "bound_ms": max(flops / BF16_FLOP_PER_S,
                               n_bytes / HBM_BYTES_PER_S) * 1e3}
        forced = {"wgmma": (0, FA.NEVER_SHORT),
                  "short": (FA.NEVER_LONG, FA.SHORT_KEYS),
                  "mma.sync": (FA.NEVER_LONG, FA.NEVER_SHORT)}
        for name, (long_from, short_to) in forced.items():
            if FA.instance(S, G, D, torch.bfloat16, window=window,
                           softcap=softcap, long_from=long_from,
                           short_to=short_to) != name:
                continue               # this shape cannot run it
            lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)

            def call(with_lse, lf=long_from, st=short_to):
                return FA._forward(q, k, v, True, window, softcap, scale,
                                   lse if with_lse else None, long_from=lf,
                                   short_to=st)
            r = {"ms": timed(lambda: call(False)),
                 "lse_ms": timed(lambda: call(True))}
            if not args.no_check:
                errs = {}
                for with_lse in (False, True):
                    got, again = call(with_lse), call(with_lse)
                    err, n = 0.0, max(1, (1 << 28) // (Hq * S * S))
                    for b in range(0, B, n):
                        want = FA.flash_attention_ref(
                            q[b:b + n], k[b:b + n], v[b:b + n], **kw)
                        err = max(err, float((got[b:b + n].float()
                                              - want.float()).abs().max()))
                    errs["lse" if with_lse else "serving"] = {
                        "max_abs_err": err,
                        "repeat_bits": bool(torch.equal(
                            got.view(torch.int16), again.view(torch.int16)))}
                lse_want = FA.flash_attention_lse_ref(q, k, **kw)
                errs["lse_max_abs_err"] = float((lse - lse_want).abs().max())
                r["check"] = errs
            row[name] = r
        mask = None                    # SDPA has no softcap
        if 0 < window < S:
            pos = torch.arange(S, device=dev)
            mask = ((pos[None, :] <= pos[:, None])
                    & (pos[None, :] > pos[:, None] - window))
        with torch.no_grad():
            row["sdpa_ms"] = timed(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, is_causal=mask is None, enable_gqa=True))
        print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
