"""Design choices of the attention kernels, timed side by side.

The forward: each variant is ``csrc/flash_attention.cu`` with one named
edit (a tile size, the consumers' turns, where O is rescaled and P
packed, an exp2 on the FMA pipe, the softcap's tanh, or a diagnostic
that drops the K/V loads), called through its own
``flash_attention_launch`` with the wgmma instance forced (``long_from``
0). With ``--short``: each variant is the same source with one named edit
of ``SHORT_VARIANTS`` (the short instance's consumer warpgroups or ring
depth, or the forward's ``mma.sync`` instance that it replaced at the
evaluators' S 31), called with the short instance forced (``long_from``
``NEVER_LONG``, ``short_to`` at its key tile) at the evaluators' shapes.
With ``--backward``: each variant is
``csrc/flash_attention_bwd.cu`` with one named edit of ``BWD_VARIANTS``
(the kernels the warpgroup kernels replaced, and at D 16 those taken
apart; a design choice of the warpgroup kernels; at D 16 diagnostics
that leave a step out), called through its own
``flash_attention_bwd_launch`` on the o and lse of the port's forward,
with SDPA's backward timed before and after the variants. With ``--decode``: each variant is
``csrc/flash_decode.cu`` with one named edit of ``DECODE_VARIANTS`` (the
pieces kernel without its K/V loads or its math, with shorter pieces,
its combine pass alone; the TMA instance with pieces of 256 positions in
place of the tile split, with P rounded to bf16 once, with one combine
warp a (row, head) as the pieces kernel has, its combine pass alone),
called through its own ``flash_decode_launch`` with the instance its
name starts with forced, at gemma2-2b's two decode shapes (B 16, L 8192,
8/4 heads, D 256, softcap 50, window 4096 and none) on the inputs of
``decode_case``; the committed source runs both instances. Every variant
is built with the port's ``nvcc`` flags, one process each, all at once.
Run on a machine with an H100:

    python3 src/repro_torch/launch/ab_attention.py
        [--backward | --short | --decode] [VARIANT ...]
        [--shape B,S,Hq,Hkv,D[,softcap[,window]] ...] [--iters N]

(``--decode`` shapes: B,L,Hq,Hkv,D,softcap,window.) With no variant
named, all of ``VARIANTS`` (or ``SHORT_VARIANTS``, ``BWD_VARIANTS``,
``DECODE_VARIANTS``). Prints,
per variant, what ptxas said of its wgmma kernels (registers, spills,
serialised wgmma), then one JSON line a shape: each variant's mean
CUDA-event time (1 GiB written between launches), in turns (the variants
in order, then reversed), and its error against the plain version: the
forward serving (P split) and with the lse (bf16 P once), max abs against
``flash_attention_ref``; the backward each of dq, dk, dv as max abs over
the plain output's max abs (``flash_attention_bwd_ref``); the decode
max abs against ``flash_decode_ref``, beside the bound of the valid
cache's bytes. The diagnostics compute no attention and their errors are
large by design. Exits 2 without a card.
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
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
DECODE_SOURCE = SOURCE.with_name("flash_decode.cu")

_KBN = ("static constexpr int kBN =\n"
        "      D == 64 ? (kSplit ? 96 : 128) : D == 128 ? (kSplit ? 64 : 96)\n"
        "                                               : (kColSplit ? 64 : 48);")
_TURNS = "static constexpr bool kTurns = D == 64;"
_QBUFS = ("static constexpr int kQBufs = kFree - 2 * kQ < 3 * 2 * kKV ? 1 "
          ": 2;")
_KV_LOADS = """        hop::tma_load_4d(sm + C::oK + s * C::kKV + c * C::kKVHalf, tk,
                         64 * c, hk, (w.j0 + j) * C::kBN, w.b, full + s);
        hop::tma_load_4d(sm + C::oV + s * C::kKV + c * C::kKVHalf, tv,
                         64 * c, hk, (w.j0 + j) * C::kBN, w.b, full + s);"""
_RESCALE = """      rescale();
      hop::fence_regs(o);
      hop::wgmma_fence();
      pv_product"""
_PACK = """      pack();
      hop::wgmma_wait<0>();                // P_{j-1} V_{j-1} is in
      fence_pv();
      release_stage(prev);
      take_p();"""
_EXP = """        s[4 * n + e] = tc::exp2_approx(fmaf(s[4 * n + e], a.c_exp, off));"""
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
    "d64_split_128keys": [(_KBN, _KBN.replace("(kSplit ? 96 : 128)", "128"))],
    "d64_split_64keys": [(_KBN, _KBN.replace("(kSplit ? 96 : 128)",
                                             "(kSplit ? 64 : 128)"))],
    "d128_lse_64keys": [(_KBN, _KBN.replace("(kSplit ? 64 : 96)", "64"))],
    # D 256: design (a) as first built, 32-key tiles (two Q buffers, three
    # stages), and with one Q buffer (five stages); design (b), the column
    # split (the lse instance; the serving one keeps the row split); 64-
    # and 80-key tiles (one Q buffer, two stages); 48 keys with two Q
    # buffers (two stages); the consumers' turns; libdevice tanhf for the
    # softcap
    "d256_32keys": [(_KBN, _KBN.replace("(kColSplit ? 64 : 48)", "32"))],
    "d256_32keys_1q": [(_KBN, _KBN.replace("(kColSplit ? 64 : 48)", "32")),
                       (_QBUFS, "static constexpr int kQBufs = "
                                "D == 256 ? 1 : 2;")],
    "d256_col_split": [("constexpr bool kColSplitD256 = false;",
                        "constexpr bool kColSplitD256 = true;")],
    "d256_64keys": [(_KBN, _KBN.replace("(kColSplit ? 64 : 48)", "64"))],
    "d256_80keys": [(_KBN, _KBN.replace("(kColSplit ? 64 : 48)", "80"))],
    "d256_2q": [(_QBUFS, "static constexpr int kQBufs = 2;")],
    "d256_turns": [(_TURNS, "static constexpr bool kTurns = D != 128;")],
    "d256_tanhf": [("        s[i] = a.cap_out * tc::tanh_ex2(s[i] * a.cap_in);",
                    "        s[i] = a.cap_out * tanhf(s[i] * a.cap_in);")],
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
                  (_EXP, """        const float x = fmaf(s[4 * n + e], a.c_exp, off);
        s[4 * n + e] = C::NO == 32 && C::kBN == 128 && n % 4 == 3
                           ? exp2_poly(x) : tc::exp2_approx(x);""")],
    # diagnostics: no K/V loads (the barrier completes with no bytes), and
    # every tile reading the K/V of (batch row 0, KV head 0)
    "diag_no_kv_loads": [(_KV_LOADS, ""),
                         ("hop::mbar_expect(full + s, 2 * C::kKV);",
                          "hop::mbar_arrive(full + s);")],
    "diag_same_kv": [(_KV_LOADS, _KV_LOADS.replace(
        "64 * c, hk, (w.j0 + j) * C::kBN, w.b,",
        "64 * c, 0, (w.j0 + j) * C::kBN, 0,"))],
}
_SHORT_RULE = ("    if (S <= short_to && sq::fits(S, Hq / Hkv) && window <= 0 "
               "&&")
# name -> [(old, new)]: edits of the short instance as committed
_WGS = "constexpr int kConsumerWGs = D == 64 ? 3 : 2;"
SHORT_VARIANTS = {
    # the consumer warpgroups taking the pairs in turn: one at both D, two
    # at D 64, three at D 128 (where qwen3-moe's ring has 2 stages, too
    # few for three to own one each: its launch is refused)
    "short_1wg": [(_WGS, "constexpr int kConsumerWGs = 1;")],
    "short_2wg_d64": [(_WGS, "constexpr int kConsumerWGs = 2;")],
    "short_3wg_d128": [(_WGS, "constexpr int kConsumerWGs = 3;")],
    # the ring at most 3 or 12 stages deep (each warpgroup owning one
    # stage, or up to four where shared memory holds them), for the 8 as
    # committed
    "short_ring3": [("constexpr int kMaxStages = 8;",
                     "constexpr int kMaxStages = 3;")],
    "short_ring12": [("constexpr int kMaxStages = 8;",
                      "constexpr int kMaxStages = 12;")],
    # the kernel it replaced: the rule never takes the short instance, so
    # the forced call runs the mma.sync one
    "short_mma_sync": [(_SHORT_RULE,
                        _SHORT_RULE.replace("S <= short_to", "false"))],
}
_BWD_PATH = ("return dtype == 1 && (D == 16 || D == 64 || D == 128 || "
             "D == 256);")
_BWD_F32 = "    if (D == 256) FB_CASE(launch_f32, 256);\n  }\n"


def _mma_sync(D: int) -> list:
    """The edits that send bf16 at head dimension ``D`` to the mma.sync
    dk/dv and dq kernels (``launch_bf16``) that the warpgroup kernel
    replaced."""
    return [(_BWD_PATH, _BWD_PATH.replace(f"D == {D} || ", "")
             .replace(f" || D == {D})", ")")),
            (_BWD_F32, _BWD_F32.replace(
                "  }\n", f"  }} else {{\n    if (D == {D}) "
                         f"FB_CASE(launch_bf16, {D});\n  }}\n"))]


_SHARE = "constexpr bool kByRoles = D == 128 || D == 256;"
_D16_MMA = _mma_sync(16)
_DQ_LAUNCH = "  dq_bf16_kernel<D><<<"
_DKDV_LAUNCH = "  dkdv_bf16_kernel<D><<<"
_DQ_SCORE = """          score_grad(s[n][e], dp[n][e], drow[h], lrow[h], scale, c_exp,
                     softcap, pv, dsv);"""
_DQ_NO_EXP = """          pv = fmaf(s[n][e], c_exp, -lrow[h]);
          dsv = pv * (dp[n][e] - drow[h]);"""
_DKDV_QLOADS = """      tc::cp_async16(qs + rr * DP + c * 8, qb + off, ok);
      tc::cp_async16(ds + rr * DP + c * 8, db + off, ok);
"""
_D16_MATH = """          if (a.softcap > 0.f) {
            if (open)
              score_math16<true, false>(a, sc, dp, ls, is, key, q0, tig);
            else
              score_math16<true, true>(a, sc, dp, ls, is, key, q0, tig);
          } else if (open) {
            score_math16<false, false>(a, sc, dp, ls, is, key, q0, tig);
          } else {
            score_math16<false, true>(a, sc, dp, ls, is, key, q0, tig);
          }
"""
_D16_ACC = ["        dkdv16(dv[0], dk[0], pa, da, dos, qs);\n",
            "        dkdv16(dv[1], dk[1], pa, da, dos, qs);\n"]
_D16_DQ = "        dq16(dq0, dq1, base + L::oDS, ks);\n"
_D16_EXP = """        f[0] = p[0] = tc::exp2_approx(fmaf(s2[0], a.c_exp, -l2.x));
        f[1] = p[1] = tc::exp2_approx(fmaf(s2[1], a.c_exp, -l2.y));
"""
_D16_PAIR_EXP = """        const uint32_t y = exp2_bf16x2(tc::pack_bf16(
            fmaf(s2[0], a.c_exp, -l2.x), fmaf(s2[1], a.c_exp, -l2.y)));
        f[0] = p[0] = __uint_as_float(y << 16);
        f[1] = p[1] = __uint_as_float(y & 0xffff0000u);
"""
_D16_MATH_HEAD = "// P^T and dS^T of one half in place of S^T (sc) and dP^T"
_D16_STAGES = "  static constexpr int kStages = 4;      // Q / dO / lse / Di"
_BF16X2 = """__device__ __forceinline__ uint32_t exp2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\\n" : "=r"(y) : "r"(x));
  return y;
}

"""
_D16_QLOADS = """        hop::tma_load_4d(sm + L::oQ + s * L::kQ, tq, 0, h, m * kR, b,
                         bar.full + s);
        hop::tma_load_4d(sm + L::oDO + s * L::kQ, tdo, 0, h, m * kR, b,
                         bar.full + s);
"""
_NO_ADDS = ("""    if (note.target == 0)                // the query tile's first partial
      hop::bulk_store(a.dq_acc + note.tile, src, kFloats * 4);
    else
      hop::bulk_reduce_add(a.dq_acc + note.tile, src, kFloats * 4);
""", """    asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
""")
_D16_SLOT = """  uint8_t* sm = block + wg * L::kPipe;
  const Bars16 bar(sm);
  const volatile int* slot =
      reinterpret_cast<const volatile int*>(sm + L::oTile);
"""
_D16_TURNS = [
    (_D16_SLOT, _D16_SLOT + """  // a pipeline's done flag at its oTile + 8, the block's turn at
  // pipeline 0's oTile + 12
  volatile int* turn = reinterpret_cast<volatile int*>(block + L::oTile + 12);
  volatile int* done = reinterpret_cast<volatile int*>(sm + L::oTile + 8);
  const volatile int* partner_done = reinterpret_cast<const volatile int*>(
      block + (1 - wg) * L::kPipe + L::oTile + 8);
  auto take_turn = [&]() {
    if (tid == 0) {
      const long long t0 = clock64();
      while (*turn != wg && !*partner_done && clock64() - t0 < 2000) {
      }
    }
    hop::named_sync(3 + wg, 128);
  };
  auto pass_turn = [&]() {
    if (tid == 0) *turn = 1 - wg;
  };
"""),
    ("      if (tid == 0) notes[buf].done = 1;\n"
     "      hop::mbar_arrive(bar.dq_full + buf);\n",
     "      if (tid == 0) notes[buf].done = 1;\n"
     "      if (tid == 0) *done = 1;\n"
     "      hop::mbar_arrive(bar.dq_full + buf);\n"),
    *[(f"        half(sc, dp, {h});\n",
       f"        take_turn();\n        half(sc, dp, {h});\n") for h in (0, 1)],
    (_D16_ACC[0] + "        hop::wgmma_commit();\n",
     _D16_ACC[0] + "        hop::wgmma_commit();\n        pass_turn();\n"),
    (_D16_DQ + "        hop::wgmma_commit();\n",
     _D16_DQ + "        hop::wgmma_commit();\n        pass_turn();\n"),
    ("        hop::mbar_init(bar.dq_empty + i, 1);\n      }\n",
     "        hop::mbar_init(bar.dq_empty + i, 1);\n      }\n"
     "      *reinterpret_cast<int2*>(sm + p * L::kPipe + L::oTile + 8) =\n"
     "          make_int2(0, 0);\n")]
# name -> [(old, new)]: edits of csrc/flash_attention_bwd.cu as committed
BWD_VARIANTS = {
    # the kernels the D 128 and D 256 instances replaced: at D 128 the two
    # warpgroups sharing 128 keys by halves (which spills), at D 256 the
    # mma.sync dk/dv and dq kernels
    "d128_key_halves": [(_SHARE, "constexpr bool kByRoles = D == 256;")],
    "d256_mma_sync": _mma_sync(256),
    # the role split's softcap with libdevice's tanhf, as `score_grad`
    # takes it, in place of tanh_ex2
    "tanhf": [("    const float t = softcap * tc::tanh_ex2(s * scale / softcap);",
               "    const float t = softcap * tanhf(s * scale / softcap);")],
    # the kernels the D 16 instance replaced (the mma.sync dk/dv and dq
    # kernels), and those taken apart: its dk/dv kernel or its dq kernel
    # alone, the dq kernel with no exp (P's argument used as P), and the
    # dk/dv kernel with no Q / dO loads (stale tiles scored)
    "d16_mma_sync": _D16_MMA,
    "d16_dkdv_only": _D16_MMA + [(_DQ_LAUNCH,
                                  "  if (false) " + _DQ_LAUNCH[2:])],
    "d16_dq_only": _D16_MMA + [(_DKDV_LAUNCH,
                                "  if (false) " + _DKDV_LAUNCH[2:])],
    "d16_dq_no_exp": _D16_MMA + [(_DKDV_LAUNCH,
                                  "  if (false) " + _DKDV_LAUNCH[2:]),
                                 (_DQ_SCORE, _DQ_NO_EXP)],
    "d16_dkdv_no_loads": _D16_MMA + [(_DQ_LAUNCH,
                                      "  if (false) " + _DQ_LAUNCH[2:]),
                                     (_DKDV_QLOADS, "")],
    # the D 16 instance taken apart: P's argument used as P (no exp: what
    # the SFU costs); the dQ writers issuing no adds (empty bulk groups,
    # counters released in order); no Q / dO loads (stale tiles scored);
    # each step of a query tile left out in turn (the score math, S and dP
    # taken as P and dS; dV and dK; the dQ product); one pipeline a block
    # (the second consumer warpgroup idle). Their results are wrong.
    "d16_no_exp": [(_D16_EXP, _D16_EXP.replace("tc::exp2_approx", ""))],
    "d16_no_dq_adds": [_NO_ADDS],
    "d16_no_q_loads": [(_D16_QLOADS, ""),
                       ("hop::mbar_expect(bar.full + s, 2 * L::kQ + 2 * kR * 4);",
                        "hop::mbar_expect(bar.full + s, 2 * kR * 4);")],
    "d16_no_math": [(_D16_MATH, "")],
    "d16_no_dkdv": [(x, "") for x in _D16_ACC],
    "d16_no_dq_product": [(_D16_DQ, "")],
    "d16_one_pipeline": [("constexpr int k16Pipes = 2;",
                          "constexpr int k16Pipes = 1;")],
    # and design choices: two exps an SFU op (ex2.approx.ftz.bf16x2, the
    # argument and P rounded to bf16); the two pipelines taking their
    # score math in turns, as FlashAttention-3's forward does its softmax
    # (a turn a hint: one that has waited 2000 clocks goes on, since the
    # other may wait on its dQ order, and one whose partner has finished
    # never waits); the Q / dO ring 12 stages deep (4 as committed)
    "d16_pair_exp": [(_D16_MATH_HEAD, _BF16X2 + _D16_MATH_HEAD),
                     (_D16_EXP, _D16_PAIR_EXP)],
    "d16_turns": _D16_TURNS,
    "d16_12_stages": [(_D16_STAGES, _D16_STAGES.replace("= 4; ", "= 12;"))],
}
_CP_ASYNC = """      tc::cp_async16(ks + j * Lay::kRowBytes + part * 16, k + off, ok);
      tc::cp_async16(vs + j * Lay::kRowBytes + part * 16, v + off, ok);
"""
_TILE_CALL = """    math.tile(ring + stage * Lay::kStageBytes, n_valid, scale, softcap,
              lane);
"""
_TMA_LAUNCH = """  flash_decode_tma_kernel<<<W, kThreads, kSmemBytes, stream>>>(tk, tv, tq,
                                                               a);
"""
_TMA_LOADS = """        hop::tma_load_4d(kp + c * kBoxBytes, &tk, 64 * c, wk.hk, pos, wk.b,
                         full + st);
        hop::tma_load_4d(kp + kKV + c * kBoxBytes, &tv, 64 * c, wk.hk, pos,
                         wk.b, full + st);
        hop::tma_load_4d(kp + 2 * kKV + c * 1024, &tq, 64 * c, wk.hk * a.G,
                         0, wk.b, full + st);
"""
_SYNC = """  hop::fence_async_smem();
  __syncthreads();
"""
_TRIGGER = """  asm volatile("griddepcontrol.launch_dependents;\\n" ::: "memory");
"""
_SKIP_MATH = """    if (lane == 0) hop::mbar_arrive(empty + st);
    if (!wk.advance(a)) break;
    continue;
"""
_TMA_WAIT = """    hop::mbar_wait(full + st, (i / kStages) & 1);
    __syncwarp();
"""
# name -> [(old, new)]: edits of csrc/flash_decode.cu as committed; a
# name starting "pieces" runs the pieces kernel, "tma" the TMA instance
DECODE_VARIANTS = {
    # the pieces kernel taken apart: no K/V loads (the ring's stale rows
    # are scored), no math (nothing scored, partials unwritten), pieces
    # capped at 64 and 128 positions for 256, and its combine pass alone
    # (the pieces kernel not launched: it merges stale partials)
    "pieces_no_loads": [(_CP_ASYNC, "")],
    "pieces_no_math": [(_TILE_CALL, "")],
    "pieces_64": [("constexpr int kMaxPieceTiles = 8;",
                   "constexpr int kMaxPieceTiles = 2;")],
    "pieces_128": [("constexpr int kMaxPieceTiles = 8;",
                    "constexpr int kMaxPieceTiles = 4;")],
    "pieces_combine_only": [("  if (blocks > 0) {\n    flash_decode_pieces",
                             "  if (false) {\n    flash_decode_pieces")],
    # the TMA instance: units of 4 tiles (pieces of 256 positions) in
    # place of the tile split; P rounded to bf16 once (16 wgmma a tile
    # for P V in place of 32); one combine warp a (row, head), as the
    # pieces kernel's combine; its combine pass alone (stale partials);
    # and a diagnostic with no K/V or q loads (the barrier completes with
    # no bytes: stale tiles are scored)
    "tma_256_pieces": [("constexpr int kUnitTiles = 1;",
                        "constexpr int kUnitTiles = 4;")],
    "tma_p_once": [("constexpr bool kSplitP = true;",
                    "constexpr bool kSplitP = false;")],
    "tma_old_combine": [("constexpr int kCombineCols = 64;",
                         "constexpr int kCombineCols = 256;")],
    "tma_combine_only": [(_TMA_LAUNCH, "")],
    "tma_no_loads": [(_TMA_LOADS, ""),
                     ("      hop::mbar_expect(full + st, tx);",
                      "      hop::mbar_arrive(full + st);")],
    # the combine launched after the main kernel ends as an ordinary
    # launch, or triggered by the main kernel's blocks as they start (its
    # blocks then wait under the main kernel); and a diagnostic whose
    # consumer only releases each stage (the TMA stream alone: nothing
    # scored, partials unwritten)
    "tma_late_combine": [("constexpr bool kDependentCombine = true;",
                          "constexpr bool kDependentCombine = false;")],
    "tma_early_combine": [(_SYNC, _SYNC + _TRIGGER)],
    "tma_no_math": [(_TMA_WAIT, _TMA_WAIT + _SKIP_MATH)],
    # the same diagnostic reading the same bytes with the Hkv = 4 heads
    # of 16 positions in one box (2 KB contiguous a position) in place of
    # 64 positions of one head (512 B of every 2 KB): whether DRAM
    # locality holds the stream (gemma2's Hkv 4 only)
    "tma_no_math_heads_together": [
        (_TMA_WAIT, _TMA_WAIT + _SKIP_MATH),
        ("hop::tensor_map(&tk, k, sh.B, sh.L, sh.Hkv, kD, rows)",
         "hop::tensor_map(&tk, k, sh.B, sh.L, sh.Hkv, kD, 16, 4)"),
        ("hop::tensor_map(&tv, v, sh.B, sh.L, sh.Hkv, kD, rows)",
         "hop::tensor_map(&tv, v, sh.B, sh.L, sh.Hkv, kD, 16, 4)"),
        (_TMA_LOADS, _TMA_LOADS.replace("64 * c, wk.hk, pos, wk.b,",
                                        "64 * c, 0, pos + 16 * wk.hk, wk.b,")
         .replace("64 * c, wk.hk, pos,\n                         wk.b,",
                  "64 * c, 0, pos + 16 * wk.hk,\n                         wk.b,"))],
}
DECODE_DEFAULT_SHAPES = ["16,8192,8,4,256,50,4096", "16,8192,8,4,256,50,0"]
DECODE_SEED = 29
DEFAULT_SHAPES = ["8,4096,9,3,64", "1,1984,9,3,64", "2,4096,40,8,128",
                  "2,4096,8,4,256,50", "1,8000,8,4,256,50,4096"]
SHORT_DEFAULT_SHAPES = ["4096,31,9,3,64", "3072,31,9,3,64",
                        "4096,31,40,8,128", "2048,31,32,4,128",
                        "3072,31,16,16,128"]
BWD_DEFAULT_SHAPES = ["2,4096,40,8,128", "2,4096,8,4,256,50",
                      "8,4096,9,3,64", "8,4096,9,3,16"]
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# (long_from, short_to) of a forced call: the wgmma instance, or the short
NEVER_LONG, SHORT_KEYS = 0x7fffffff, 32
FORCE = {"wgmma": (0, 0), "short": (NEVER_LONG, SHORT_KEYS)}


def variant_table(backward: bool = False, short: bool = False,
                  decode: bool = False) -> dict:
    return BWD_VARIANTS if backward else SHORT_VARIANTS if short \
        else DECODE_VARIANTS if decode else VARIANTS


def source_of(backward: bool = False, decode: bool = False) -> Path:
    return BWD_SOURCE if backward else DECODE_SOURCE if decode else SOURCE
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p])


def variant_source(name: str, backward: bool = False,
                   short: bool = False, decode: bool = False) -> str:
    text = source_of(backward, decode).read_text()
    for old, new in variant_table(backward, short, decode)[name]:
        if old not in text:
            raise ValueError(f"variant {name}: its edit no longer applies")
        text = text.replace(old, new)
    return text


def ptxas_notes(log: str, kernel: str = "fa_fwd_wgmma_kernel") -> dict:
    """Registers, spill bytes and serialised wgmma of each instance of
    ``kernel`` (by head dimension, ``_lse`` where it writes the lse),
    from ``-Xptxas -v``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E(?:Lb([01])E)?", line)
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


def decode_ptxas_notes(log: str) -> dict:
    """Registers and spill bytes of each bf16 D 256 and TMA-instance
    kernel of ``csrc/flash_decode.cu``, from ``-Xptxas -v``, by its
    mangled name from the kernel's own name on."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?(flash_decode_\w+)'", line)
        if m:
            cur = m.group(1) if ("Li256E" in m.group(1)
                                 or "tma" in m.group(1)) else None
            if cur:
                out[cur] = {}
        elif cur is not None:
            s = re.search(r"(\d+) bytes spill stores", line)
            if s:
                out[cur]["spill_stores"] = int(s.group(1))
            r = re.search(r"Used (\d+) registers", line)
            if r:
                out[cur]["registers"] = int(r.group(1))
                cur = None
    return out


def start_variant_build(name: str, backward: bool, short: bool = False,
                        decode: bool = False):
    """Writes variant ``name`` (``committed``: the source as it is) into
    ``build/ab/<kind>/<name>/`` with the headers it includes and starts its
    ``nvcc``; returns (directory, process)."""
    from repro_torch.kernels import _build
    source = source_of(backward, decode)
    d = _build.BUILD_DIR / "ab" / ("bwd" if backward else
                                   "short" if short else
                                   "decode" if decode else "") / name
    d.mkdir(parents=True, exist_ok=True)
    for header in ("tensor_core.cuh", "wgmma.cuh"):
        (d / header).write_text((SOURCE.parent / header).read_text())
    (d / source.name).write_text(
        source.read_text() if name == "committed"
        else variant_source(name, backward, short, decode))
    return d, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
         str(d / source.name)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_variant_build(name: str, started) -> tuple:
    """Waits for a build from ``start_variant_build``; returns (the loaded
    library, the compiler's output). Raises if nvcc failed."""
    d, proc = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
    return ctypes.CDLL(str(d / "lib.so")), log


def build_variants(names, backward: bool, short: bool = False,
                   decode: bool = False) -> dict:
    """Each named variant built into ``build/ab/<name>/lib.so`` (one nvcc
    each, all at once), its ptxas notes printed; returns the loaded
    libraries by name."""
    procs = {name: start_variant_build(name, backward, short, decode)
             for name in names}
    libs = {}
    for name, started in procs.items():
        libs[name], log = finish_variant_build(name, started)
        kernel = ("fa_bwd_main_kernel" if backward else
                  "fa_fwd_short_kernel" if short else "fa_fwd_wgmma_kernel")
        notes = decode_ptxas_notes(log) if decode else ptxas_notes(log,
                                                                   kernel)
        print(json.dumps({"variant": name, "ptxas": notes}), flush=True)
    return libs


def time_forward(libs, shapes, iters: int, scratch,
                 force: str = "wgmma") -> None:
    """Each variant's ``flash_attention_launch`` on the same causal inputs
    with the ``force`` instance asked for (``FORCE``)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.time_attention import timed_ms
    names = list(libs)
    fns = {}
    for name, lib in libs.items():
        fns[name] = lib.flash_attention_launch
        fns[name].argtypes = ARGTYPES
    long_from, short_to = FORCE[force]
    dev = scratch.device
    gen = torch.Generator(device=dev).manual_seed(0)
    for spec in shapes:
        B, S, Hq, Hkv, D, *extra = spec.split(",")
        B, S, Hq, Hkv, D = (int(x) for x in (B, S, Hq, Hkv, D))
        softcap = float(extra[0]) if extra else 0.0
        window = int(extra[1]) if len(extra) > 1 else 0
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        n = max(1, (1 << 28) // (Hq * S * S))  # batch rows a plain call
        want = torch.cat([FA.flash_attention_ref(
            q[b:b + n], k[b:b + n], v[b:b + n], causal=True, window=window,
            softcap=softcap) for b in range(0, B, n)]).float()
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
        out = torch.empty_like(q)
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, S {S}, {Hq}/{Hkv}, D {D}, bf16 causal, "
                        f"softcap {softcap}, window {window}"}
        for name in names + names[::-1]:
            for kind in ("serving", "lse"):
                def call(fn=fns[name], with_lse=kind == "lse"):
                    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             out.data_ptr(),
                             lse.data_ptr() if with_lse else None, B, S, Hq,
                             Hkv, D, 1, D ** -0.5, 1, window, softcap,
                             long_from, short_to,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                cell = row.setdefault(f"{name}/{kind}", {"ms": []})
                try:
                    cell["ms"].append(timed_ms(call, iters, scratch))
                except RuntimeError as e:    # a launch the variant refuses
                    cell["error"] = str(e)
                    continue
                call()
                torch.cuda.synchronize()
                cell["max_abs_err"] = float((out.float() - want).abs().max())
        print(json.dumps(row), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()


def time_backward(libs, shapes, iters: int, scratch) -> None:
    """Each variant's ``flash_attention_bwd_launch`` on the same causal
    inputs, with the o and lse of the port's forward kernel."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.time_attention import timed_ms
    names = list(libs)
    dev = scratch.device
    gen = torch.Generator(device=dev).manual_seed(0)
    for spec in shapes:
        B, S, Hq, Hkv, D, *cap = spec.split(",")
        B, S, Hq, Hkv, D = (int(x) for x in (B, S, Hq, Hkv, D))
        softcap = float(cap[0]) if cap else 0.0
        # q scaled so that a softcap bites (logits of spread ~8 x 5)
        q, k, v, do = (torch.randn((B, S, h, D), generator=gen, device=dev)
                       for h in (Hq, Hkv, Hkv, Hq))
        q, k, v, do = ((q * (8.0 if softcap else 1.0)).to(torch.bfloat16),
                       k.to(torch.bfloat16), v.to(torch.bfloat16),
                       do.to(torch.bfloat16))
        kw = dict(causal=True, window=0, softcap=softcap,
                  sm_scale=D ** -0.5)
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
        o = FA._forward(q, k, v, lse=lse, **kw)
        want = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, S {S}, {Hq}/{Hkv}, D {D}, bf16 causal, "
                        f"softcap {softcap}",
               "sdpa_backward_ms": []}
        sdpa = sdpa_backward(q, k, v, do)
        row["sdpa_backward_ms"].append(timed_ms(sdpa, iters, scratch))
        for name in names + names[::-1]:
            call = bwd_call(libs[name], q, k, v, o, lse, do, softcap=softcap)
            cell = row.setdefault(name, {"ms": []})
            cell["ms"].append(timed_ms(call, iters, scratch))
            grads = call()
            torch.cuda.synchronize()
            for g, w, what in zip(grads, want, ("dq", "dk", "dv")):
                err = float((g.float() - w.float()).abs().max())
                cell[f"{what}_rel_err"] = err / max(
                    float(w.float().abs().max()), 1e-30)
            del call, grads
        row["sdpa_backward_ms"].append(timed_ms(sdpa, iters, scratch))
        print(json.dumps(row), flush=True)
        del q, k, v, do, o, lse, want, sdpa
        torch.cuda.empty_cache()


def bwd_call(lib, q, k, v, o, lse, do, softcap: float = 0.0):
    """A causal call of a variant library's ``flash_attention_bwd_launch``
    (bf16, scale D^-0.5, no window) on these inputs, with outputs and a
    workspace of its own; returns (dq, dk, dv). Raises on a launch
    error."""
    import torch
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = BWD_ARGTYPES
    size = lib.flash_attention_bwd_workspace_bytes
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    grads = [torch.empty_like(t) for t in (q, k, v)]
    work = torch.empty(size(B, S, Hq, D, 1), dtype=torch.uint8,
                       device=q.device)

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(),
                 *(g.data_ptr() for g in grads), work.data_ptr(), B, S, Hq,
                 Hkv, D, 1, D ** -0.5, 1, 0, softcap,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"flash_attention_bwd_launch: cudaError "
                               f"{err}")
        return grads
    return call


def sdpa_backward(q, k, v, do):
    """A call of the backward of ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` on the same inputs (no softcap,
    which SDPA lacks): the library's time for the same function."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)


def decode_case(B: int, L: int, Hq: int, Hkv: int, D: int, window: int,
                device, max_len: int = 8016):
    """The bf16 inputs of a timed decode row, from a generator of its own
    seeded from the case (``DECODE_SEED`` + window), so that every run
    times the same lengths: q, the caches, and lengths drawn from 1 to
    min(L, ``max_len``) (gemma2's longest prompt and its decode steps),
    the first three set to 1, that top and the window."""
    import torch
    g = torch.Generator(device=device).manual_seed(DECODE_SEED + window)
    q = torch.randn((B, Hq, D), generator=g, device=device)
    k, v = (torch.randn((B, L, Hkv, D), generator=g, device=device)
            for _ in range(2))
    top = min(L, max_len)
    lengths = torch.randint(1, top + 1, (B,), generator=g, device=device,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([1, top, max(window, 1)], device=device)
    return (q.to(torch.bfloat16), k.to(torch.bfloat16),
            v.to(torch.bfloat16), lengths)


def decode_instance(name: str) -> int:
    """The instance a decode variant runs: 1 (the TMA instance) for a name
    starting ``tma``, else 0 (the pieces kernel)."""
    return 1 if name.startswith("tma") else 0


DECODE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])


def timed_clean_ms(call, iters: int, scratch, clean) -> float:
    """As ``time_attention.timed_ms``, with ``clean`` (256 MB) read after
    the 1 GiB write: the launch finds L2 cold but holding clean lines, so
    it pays for no write-back of the flush's dirty ones."""
    import numpy as np
    import torch
    call()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        scratch.zero_()
        clean.sum()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        call()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


def decode_device_ms(call, n: int = 5) -> dict:
    """Device time a call of each ``flash_decode`` kernel, by name, from
    the profiler over ``n`` calls (L2 warm): what a step's profile
    charges each. A kernel launched early is charged its whole span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(r"flash_decode_\w+", e.key)
        if e.device_type == DeviceType.CUDA and name:
            out[name.group(0)] = (out.get(name.group(0), 0.0)
                                  + e.device_time_total / 1e3 / n)
    return out


def time_decode(libs, shapes, iters: int, scratch) -> None:
    """Each variant's ``flash_decode_launch`` on the inputs of
    ``decode_case`` with its instance forced (the committed source: both
    instances, as ``committed/tma`` and ``committed/pieces``), in turns;
    its max abs error against ``flash_decode_ref``; the bound. ``ms``
    after the 1 GiB write (as ``chip_smoke.py`` times: L2 holds the
    write's dirty lines), ``clean_ms`` after a read as well
    (``timed_clean_ms``)."""
    import torch
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.launch.time_attention import HBM_BYTES_PER_S, timed_ms
    runs = []                               # (label, lib, instance)
    for name, lib in libs.items():
        lib.flash_decode_launch.argtypes = DECODE_ARGTYPES
        lib.flash_decode_piece_len.argtypes = [ctypes.c_int] * 5
        insts = (1, 0) if name == "committed" else (decode_instance(name),)
        runs += [(f"{name}/{'tma' if i else 'pieces'}"
                  if name == "committed" else name, lib, i) for i in insts]
    dev = scratch.device
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    for spec in shapes:
        B, L, Hq, Hkv, D, cap, window = spec.split(",")
        B, L, Hq, Hkv, D, window = (int(x) for x in (B, L, Hq, Hkv, D,
                                                     window))
        softcap, G, scale = float(cap), Hq // Hkv, D ** -0.5
        q, k, v, lengths = decode_case(B, L, Hq, Hkv, D, window, dev)
        kw = dict(window=window, softcap=softcap, sm_scale=scale)
        want = FD.flash_decode_ref(q, k, v, lengths, **kw).float()
        pos = torch.arange(L, device=dev)
        ok = pos[None, :] < lengths[:, None]
        if window > 0:
            ok &= pos[None, :] >= lengths[:, None] - window
        seen = int(ok.sum())
        n_bytes = FD.cost(B, Hq, Hkv, D, 2, seen)[1]
        row = {"card": torch.cuda.get_device_name(0),
               "shape": f"B {B}, L {L}, {Hq}/{Hkv}, D {D}, bf16, softcap "
                        f"{softcap}, window {window}",
               "mean_valid": seen / B,
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        out = torch.empty_like(q)
        for label, lib, inst in runs + runs[::-1]:
            if inst:
                piece = 0
                slots = B * Hkv + lib.flash_decode_tma_consumers()
            else:
                piece = lib.flash_decode_piece_len(B, Hkv, L, 1, D)
                slots = B * Hkv * -(-L // piece)
            part = torch.empty(slots * G * (D + 2), dtype=torch.float32,
                               device=dev)

            def call(fn=lib.flash_decode_launch, inst=inst, piece=piece,
                     slots=slots, part=part):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         lengths.data_ptr(), part.data_ptr(),
                         part[slots * G:].data_ptr(),
                         part[2 * slots * G:].data_ptr(), out.data_ptr(),
                         None, B, L, Hkv, G, D, piece, slots, 1, scale,
                         window, softcap, inst,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{label}: cudaError {err}")
            cell = row.setdefault(label, {"ms": [], "clean_ms": []})
            try:
                cell["ms"].append(timed_ms(call, iters, scratch))
                cell["clean_ms"].append(timed_clean_ms(call, iters, scratch,
                                                       clean))
            except RuntimeError as e:    # a launch the variant refuses
                cell["error"] = str(e)
                continue
            call()
            torch.cuda.synchronize()
            cell["max_abs_err"] = float((out.float() - want).abs().max())
            cell["share_of_bound"] = row["bound_ms"] / min(cell["ms"])
            cell.setdefault("device_ms", decode_device_ms(call))
            del part
        print(json.dumps(row), flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()


def card_name_and_power() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--backward", action="store_true",
                      help="variants of csrc/flash_attention_bwd.cu")
    mode.add_argument("--short", action="store_true",
                      help="variants of the forward's short instance")
    mode.add_argument("--decode", action="store_true",
                      help="variants of csrc/flash_decode.cu")
    ap.add_argument("--shape", action="append",
                    help="B,S,Hq,Hkv,D[,softcap[,window]] (causal bf16; "
                         "the backward takes no window); repeatable")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch
    if not torch.cuda.is_available():
        print("ab_attention: no CUDA device", file=sys.stderr)
        return 2
    table = variant_table(args.backward, args.short, args.decode)
    unknown = [v for v in args.variants if v not in table]
    if unknown:
        ap.error(f"unknown variants {unknown}; known: {sorted(table)}")
    print(json.dumps({"card": card_name_and_power()}), flush=True)
    libs = build_variants(["committed"] + (args.variants or list(table)),
                          args.backward, args.short, args.decode)
    scratch = torch.empty(1 << 30, dtype=torch.uint8,
                          device=torch.device("cuda"))
    if args.decode:
        time_decode(libs, args.shape or DECODE_DEFAULT_SHAPES, args.iters,
                    scratch)
    elif args.backward:
        time_backward(libs, args.shape or BWD_DEFAULT_SHAPES, args.iters,
                      scratch)
    else:
        time_forward(libs, args.shape or (SHORT_DEFAULT_SHAPES if args.short
                                          else DEFAULT_SHAPES),
                     args.iters, scratch,
                     "short" if args.short else "wgmma")
    return 0


if __name__ == "__main__":
    sys.exit(main())
