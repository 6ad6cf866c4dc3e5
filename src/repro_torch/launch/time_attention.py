"""Both bf16 instances of ``flash_attention``'s forward, side by side.

The forward has two bf16 instances (``kernels/flash_attention.py``,
``long_instance``): the ``mma.sync`` kernel with the GQA group packed
into its rows, and the warp-specialised ``wgmma`` kernel that long
sequences take. This script holds each against the plain version and
times each, with and without the lse output, beside SDPA and the bound,
at the shapes given (default: smollm-135m's training microbatch, the
decode phase's longest prefill, a D 128 training row with qwen2.5's
heads, gemma2-2b's training microbatch (D 256, softcap 50), and sweeps
of prefill lengths that place ``LONG_FROM``: smollm's heads, qwen2.5's,
and gemma2's local layer, S 128 to 8000 with its 4096-key window):

    python3 src/repro_torch/launch/time_attention.py
        [--shape B,S,Hq,Hkv,D[,softcap[,window]] ...] [--no-check] [--iters N]

One JSON line a shape: the instance ``long_instance`` picks, each
instance's ``ms`` / ``lse_ms`` and its max abs error against
``flash_attention_ref`` (one batch row at a time), two calls equal bit
for bit, SDPA's time, the bound. CUDA-event means with a 1 GiB write
between launches (L2 cold, as on the main path). Needs a CUDA device;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

DEFAULT_SHAPES = ["8,4096,9,3,64", "1,1984,9,3,64", "2,4096,40,8,128",
                  "1,128,9,3,64", "1,192,9,3,64", "1,256,9,3,64",
                  "1,384,9,3,64", "1,512,9,3,64", "1,1024,9,3,64",
                  "1,256,40,8,128", "1,512,40,8,128", "2,4096,8,4,256,50",
                  *(f"1,{s},8,4,256,50,4096" for s in (
                      128, 192, 256, 512, 1024, 2048, 4096, 8000))]
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
    for spec in args.shape or DEFAULT_SHAPES:
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
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, S {S}, {Hq}/{Hkv}, D {D}, bf16 causal, "
                        f"softcap {softcap}, window {window}",
               "instance": "wgmma" if FA.long_instance(
                   S, D, torch.bfloat16, window=window, softcap=softcap)
               else "mma.sync",
               "bound_ms": max(flops / BF16_FLOP_PER_S,
                               n_bytes / HBM_BYTES_PER_S) * 1e3}
        for name, long_from in (("wgmma", 0), ("mma.sync", FA.NEVER_LONG)):
            lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)

            def call(with_lse, lf=long_from):
                return FA._forward(q, k, v, True, window, softcap, scale,
                                   lse if with_lse else None, long_from=lf)
            r = {"ms": timed(lambda: call(False)),
                 "lse_ms": timed(lambda: call(True))}
            if not args.no_check:
                errs = {}
                for with_lse in (False, True):
                    got, again = call(with_lse), call(with_lse)
                    err = 0.0
                    for b in range(B):
                        want = FA.flash_attention_ref(
                            q[b:b + 1], k[b:b + 1], v[b:b + 1], **kw)
                        err = max(err, float((got[b:b + 1].float()
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
