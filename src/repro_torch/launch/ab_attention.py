"""Design choices of ``flash_attention``'s wgmma instance, timed side by side.

Each variant is ``csrc/flash_attention.cu`` with one named edit (a tile
size, the consumers' turns, where O is rescaled and P packed, an
exp2 on the FMA pipe, or a diagnostic that drops the K/V loads); every variant is built with the port's ``nvcc``
flags, one process each, all at once, and called through its own
``flash_attention_launch`` with the wgmma instance forced
(``long_from`` 0). Run on a machine with an H100:

    python3 src/repro_torch/launch/ab_attention.py [VARIANT ...]
        [--shape B,S,Hq,Hkv,D ...] [--iters N]

With no variant named, all of ``VARIANTS``. Prints, per variant, what
ptxas said of the four wgmma instances (registers, spills, serialised
wgmma), then one JSON line a shape: each variant's mean CUDA-event time
(1 GiB written between launches), serving (P split) and with the lse
(bf16 P once), in turns (the variants in order, then reversed), and its
max abs error against ``flash_attention_ref``; the diagnostics compute no
attention and their errors are large by design. Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "repro_torch" / "csrc" / "flash_attention.cu"

_KBN = ("static constexpr int kBN =\n"
        "      D == 64 ? (kSplit ? 96 : 128) : (kSplit ? 64 : 96);")
_TURNS = "static constexpr bool kTurns = D == 64;"
_KV_LOADS = """        hop::tma_load_4d(sm + C::oK + s * C::kKV + c * C::kKVHalf, tk,
                         64 * c, hk, j * C::kBN, w.b, full + s);
        hop::tma_load_4d(sm + C::oV + s * C::kKV + c * C::kKVHalf, tv,
                         64 * c, hk, j * C::kBN, w.b, full + s);"""
_RESCALE = """      rescale();
      hop::fence_regs(o);
      hop::wgmma_fence();
      pv_product"""
_PACK = """      pack();
      hop::wgmma_wait<0>();                // P_{j-1} V_{j-1} is in
      fence_pv();
      release_stage(prev);
      take_p();"""
_EXP = """            s[4 * n + e] = tc::exp2_approx(fmaf(s[4 * n + e], a.c_exp, off));"""
_POLY = """
// 2^x for x <= 0 on the FMA pipe: x = j + f, j = round(x); 2^f by a
// cubic with p(0) = 1 (relative error 1.0e-4); j added to the exponent.
__device__ __forceinline__ float exp2_poly(float x) {
  x = fmaxf(x, -127.f);
  const float t = x + 12582912.f;
  const float f = x - (t - 12582912.f);
  const float p = fmaf(fmaf(fmaf(0.0550088733f, f, 0.2422098219f), f,
                            0.6932827830f), f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

struct Args {"""

# name -> [(old, new)]: edits of the source as committed
VARIANTS = {
    "d64_split_128keys": [(_KBN, "static constexpr int kBN =\n"
                           "      D == 64 ? 128 : (kSplit ? 64 : 96);")],
    "d64_split_64keys": [(_KBN, "static constexpr int kBN =\n"
                          "      D == 64 ? (kSplit ? 64 : 128) : "
                          "(kSplit ? 64 : 96);")],
    "d128_lse_64keys": [(_KBN, "static constexpr int kBN =\n"
                         "      D == 64 ? (kSplit ? 96 : 128) : 64;")],
    "no_turns": [(_TURNS, "static constexpr bool kTurns = false;")],
    # O rescaled and P packed after the wait for P V (one set of P
    # registers), as the first version did
    "pack_after_wait": [(_RESCALE, "      pv_product"),
                        (_PACK, """      hop::wgmma_wait<0>();
      fence_pv();
      release_stage(prev);
      rescale();
      pack();
      take_p();"""),
                        ("      take_turn();\n      rescale();\n",
                         "      take_turn();\n"),
                        ("      pack();\n      take_p();\n    }\n    for",
                         "      pack();\n      take_p();\n      rescale();\n    }\n    for")],
    "turns_at_d128": [(_TURNS, "static constexpr bool kTurns = true;")],
    # every fourth 8-column block of S through exp2_poly (D 64, lse)
    "poly_exp2": [("\nstruct Args {", _POLY),
                  (_EXP, """            const float x = fmaf(s[4 * n + e], a.c_exp, off);
            s[4 * n + e] = D == 64 && !kSplit && n % 4 == 3
                               ? exp2_poly(x) : tc::exp2_approx(x);""")],
    # diagnostics: no K/V loads (the barrier completes with no bytes), and
    # every tile reading the K/V of (batch row 0, KV head 0)
    "diag_no_kv_loads": [(_KV_LOADS, ""),
                         ("hop::mbar_expect(full + s, 2 * C::kKV);",
                          "hop::mbar_arrive(full + s);")],
    "diag_same_kv": [(_KV_LOADS, _KV_LOADS.replace(
        "64 * c, hk, j * C::kBN, w.b,", "64 * c, 0, j * C::kBN, 0,"))],
}
DEFAULT_SHAPES = ["8,4096,9,3,64", "1,1984,9,3,64", "2,4096,40,8,128"]
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_void_p])


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: its edit no longer applies")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str) -> dict:
    """Registers, spill bytes and serialised wgmma of each wgmma
    instance, from ``-Xptxas -v``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"fa_fwd_wgmma_kernelILi(\d+)ELb([01])E", line)
        if m and "Compiling entry" in line:
            cur = f"D{m.group(1)}" + ("_lse" if m.group(2) == "1" else "")
            out.setdefault(cur, {})
        elif m and "serialized" in line:
            key = f"D{m.group(1)}" + ("_lse" if m.group(2) == "1" else "")
            out.setdefault(key, {})["wgmma_serialized"] = True
        elif cur is not None:
            s = re.search(r"(\d+) bytes spill stores", line)
            if s:
                out[cur]["spill_stores"] = int(s.group(1))
            r = re.search(r"Used (\d+) registers", line)
            if r:
                out[cur]["registers"] = int(r.group(1))
                cur = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--shape", action="append",
                    help="B,S,Hq,Hkv,D (causal bf16); repeatable")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.time_attention import timed_ms
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2

    names = ["committed"] + list(args.variants)
    procs = {}
    for name in names:
        d = _build.BUILD_DIR / "ab" / name
        d.mkdir(parents=True, exist_ok=True)
        for header in ("tensor_core.cuh", "wgmma.cuh"):
            (d / header).write_text((SOURCE.parent / header).read_text())
        (d / "flash_attention.cu").write_text(
            SOURCE.read_text() if name == "committed"
            else variant_source(name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
        print(json.dumps({"variant": name, "ptxas": ptxas_notes(log)}),
              flush=True)
        fn = ctypes.CDLL(str(_build.BUILD_DIR / "ab" / name / "lib.so")
                         ).flash_attention_launch
        fn.argtypes = ARGTYPES
        fns[name] = fn

    dev = torch.device("cuda")
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    for spec in args.shape or DEFAULT_SHAPES:
        B, S, Hq, Hkv, D = (int(x) for x in spec.split(","))
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        want = torch.cat([FA.flash_attention_ref(
            q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=True)
            for b in range(B)]).float()
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, S {S}, {Hq}/{Hkv}, D {D}, bf16 causal"}
        for name in names + names[::-1]:
            for kind in ("serving", "lse"):
                def call(fn=fns[name], with_lse=kind == "lse"):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if with_lse else None, B, S, Hq,
                             Hkv, D, 1, D ** -0.5, 1, 0, 0.0, 0,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                cell = row.setdefault(f"{name}/{kind}", {"ms": []})
                cell["ms"].append(timed_ms(call, args.iters, scratch))
                call()
                torch.cuda.synchronize()
                cell["max_abs_err"] = float((out.float() - want).abs().max())
        print(json.dumps(row), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
