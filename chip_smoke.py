#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes the main path
gives it, then drives the main path — the fused drain
(``FusedLoadShedder`` under ``DrainExecutor``) with a full-width
smollm-135m trust evaluator on seeded random weights — and checks it
against the port's host ``LoadShedder``. Any failure raises and exits
non-zero. Without a CUDA device it exits non-zero before printing any
result.

Output: one line per phase; then the card's name and power limit (as
``nvidia-smi`` reports them), the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.

Numerics: TF32 is switched off for matmuls and cuDNN, so float32
products are full float32 and the tolerances below hold.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import TrustIRConfig, get_config  # noqa: E402
from repro_torch.core import trust_cache as TC  # noqa: E402
from repro_torch.core.deadline import effective_deadline  # noqa: E402
from repro_torch.core.fused_shedder import FusedLoadShedder  # noqa: E402
from repro_torch.core.load_monitor import LoadMonitor  # noqa: E402
from repro_torch.core.regimes import Regime  # noqa: E402
from repro_torch.core.shedder import (TIER_INVALID, LoadShedder,  # noqa: E402
                                      SimClock)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.shed_partition import (  # noqa: E402
    shed_partition, shed_partition_ref)
from repro_torch.scheduling.executor import DrainExecutor  # noqa: E402
from repro_torch.serving.evaluators import make_evaluator  # noqa: E402

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s. The bound of a kernel is the larger of bytes / HBM rate and
# operations / peak rate for its type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

SEED = 0
BATCH = 4096                     # micro-batch capacity of the main path
DOC_LEN = 32                     # evaluator tokens per document (S = 31)
N_LAYERS = get_config("smollm-135m").n_layers
BF16_ATOL = 2e-2                 # kernel vs plain, bf16 output rounding
F32_ATOL = 1e-4                  # kernel vs plain, f32 summation order
TRUST_ATOL = 5e-2                # fused vs host drain (phase_regime_parity)


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_ms(fn, iters: int, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events
    around each call; ``flush`` runs between calls outside the timed
    span (to evict L2 where the caller would find it cold)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    t0 = time.monotonic()
    logs = _build.build(["shed_partition", "flash_attention"])
    log(f"build: {len(logs)} kernels compiled in "
        f"{time.monotonic() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: shed_partition against its plain version
# ---------------------------------------------------------------------------

def production_cache(cfg: TrustIRConfig, gen: torch.Generator, dev):
    """The production Trust DB (65536 slots x 4 ways) filled to about half
    with seeded keys through ``TC.insert``; returns it and its keys."""
    state = TC.init(cfg.cache_slots, cfg.cache_ways, device=dev)
    inserted = []
    while float(TC.occupancy(state)) < 0.5:
        keys = torch.randint(1, 2 ** 31 - 1, (40_000,), generator=gen,
                             device=dev, dtype=torch.int32)
        keys = keys | (torch.randint(0, 2, keys.shape, generator=gen,
                                     device=dev, dtype=torch.int32) << 31)
        vals = torch.rand(keys.shape, generator=gen, device=dev) * 5
        state = TC.insert(state, keys, vals,
                          torch.ones_like(keys, dtype=torch.bool))
        inserted.append(keys)
    return state, torch.cat(inserted)


def shed_bytes(keys, valid, ck, cv) -> int:
    """Bytes the function must move for these inputs: keys and flags read,
    three outputs written, and for each valid nonzero key the set's way
    keys up to its hit (all ways on a miss) plus the hit's value."""
    n_slots, n_ways, wl = TC.dims(tuple(ck.shape))
    slot = TC.slots_of(keys, n_slots)
    match = TC.candidates(ck, slot, wl) == keys[:, None]
    hit = match.any(-1)
    first = match.to(torch.int8).argmax(-1) + 1
    probe = valid & (keys != 0)
    ways_read = torch.where(hit, first, torch.full_like(first, n_ways))
    n_probe_bytes = int((ways_read * 4 + hit.to(torch.int64) * 4)[probe]
                        .sum())
    n = keys.shape[0]
    return n * (4 + 1) + n * 12 + n_probe_bytes


def phase_shed_partition(cfg: TrustIRConfig, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, cached = production_cache(cfg, gen, dev)
    log(f"shed_partition: production cache {tuple(state['keys'].shape)} "
        f"occupancy {float(TC.occupancy(state)):.3f}")
    layouts = {
        "ways-leading": (state["keys"], state["values"]),
        "slots-leading": (state["keys"].T.contiguous(),
                          state["values"].T.contiguous()),
    }
    ucap, uthr = cfg.u_capacity, cfg.u_threshold
    max_err, cases = 0.0, 0
    timing = None
    for n in (0, 1, 1000, BATCH, 8192 + 37):
        # half the probes are cached keys (hits), half fresh (misses)
        pick = torch.randint(0, cached.shape[0], (n,), generator=gen,
                             device=dev)
        fresh = torch.randint(1, 2 ** 31 - 1, (n,), generator=gen,
                              device=dev, dtype=torch.int32)
        keys = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                           cached[pick], fresh).contiguous()
        n_valid = n - n // 10
        valid = torch.arange(n, device=dev) < n_valid
        deadline = effective_deadline(
            n_valid, ucap, uthr, deadline_s=cfg.deadline_s,
            overload_deadline_s=cfg.overload_deadline_s,
            weight=cfg.very_heavy_weight)
        budget_total = int(np.floor(ucap / cfg.deadline_s * deadline))
        for layout, (ck, cv) in layouts.items():
            for total, budget in ((True, budget_total), (False, 700)):
                got = shed_partition(keys, valid, ck, cv, ucap, uthr,
                                     budget, budget_is_total=total)
                want = shed_partition_ref(keys, valid, ck, cv, ucap, uthr,
                                          budget, budget_is_total=total)
                torch.cuda.synchronize()
                for g, w, name in zip(got, want, ("tier", "cval", "rank")):
                    if not torch.equal(g, w):
                        bad = int((g != w).sum())
                        raise AssertionError(
                            f"shed_partition {name} differs from the plain "
                            f"version at N={n} {layout} budget_is_total="
                            f"{total}: {bad} items")
                cases += 1
                if n and got[0].numel():
                    max_err = max(max_err, float(
                        (got[1] - want[1]).abs().max()))
        if n == BATCH:
            ck, cv = layouts["ways-leading"]
            # 1 GiB written between launches evicts the 50 MB L2 (the
            # evaluator's traffic does so on the main path) and keeps the
            # card busy (~0.3 ms) while the host enqueues the timed launch,
            # so the events time the kernel, not the host's launch path.
            scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)

            def flush():                      # the Trust DB arrives cold
                scratch.zero_()

            args = (keys, valid, ck, cv, ucap, uthr, budget_total)
            timing = {
                "ms": timed_ms(lambda: shed_partition(
                    *args, budget_is_total=True), 200, flush),
                "plain_ms": timed_ms(lambda: shed_partition_ref(
                    *args, budget_is_total=True), 50, flush),
                "bytes": shed_bytes(keys, valid, ck, cv),
            }
    bound_ms = timing["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"shed_partition: {cases} cases exactly equal to the plain version "
        f"(N in 0, 1, 1000, 4096, 8229; both layouts; both budget modes)")
    log(f"shed_partition @N={BATCH}: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, bound {bound_ms:.6f} ms "
        f"({timing['bytes']} B)")
    return {"name": "shed_partition", "route": "cuda",
            "source": "src/repro_torch/csrc/shed_partition.cu",
            "replaces": "src/repro/kernels/shed_partition.py:200",
            "max_abs_err": max_err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


# ---------------------------------------------------------------------------
# phase 4: flash_attention against its plain version
# ---------------------------------------------------------------------------

def attention_inputs(B, S, Hq, Hkv, D, dtype, gen, dev):
    return tuple(torch.randn((B, S, h, D), generator=gen, device=dev)
                 .to(dtype) for h in (Hq, Hkv, Hkv))


def phase_flash_attention(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    cfg = get_config("smollm-135m")
    B, S, Hq, Hkv, D = BATCH, DOC_LEN - 1, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_head
    q, k, v = attention_inputs(B, S, Hq, Hkv, D, torch.bfloat16, gen, dev)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not torch.isfinite(got).all() or err > BF16_ATOL:
        raise AssertionError(f"flash_attention bf16 B={B} S={S}: max abs "
                             f"err {err} > {BF16_ATOL}")
    log(f"flash_attention bf16 (B={B}, S={S}, Hq={Hq}, Hkv={Hkv}, D={D}, "
        f"causal): max abs err {err:.3e} <= {BF16_ATOL}")

    q2, k2, v2 = attention_inputs(4, 1024, 9, 3, 64, torch.float32, gen, dev)
    got2 = flash_attention(q2, k2, v2, causal=True, window=256,
                           softcap=50.0)
    want2 = flash_attention_ref(q2, k2, v2, causal=True, window=256,
                                softcap=50.0)
    torch.cuda.synchronize()
    err2 = float((got2 - want2).abs().max())
    if not torch.isfinite(got2).all() or err2 > F32_ATOL:
        raise AssertionError(f"flash_attention f32 S=1024 window softcap: "
                             f"max abs err {err2} > {F32_ATOL}")
    log(f"flash_attention f32 (B=4, S=1024, 9/3 heads, window=256, "
        f"softcap=50): max abs err {err2:.3e} <= {F32_ATOL}")

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    lib = library().transpose(1, 2)
    lib_err = float((lib.float() - want.float()).abs().max())
    timing = {
        "ms": timed_ms(lambda: flash_attention(q, k, v, causal=True), 20),
        "plain_ms": timed_ms(lambda: flash_attention_ref(q, k, v,
                                                         causal=True), 5),
        "library_ms": timed_ms(library, 20),
    }
    n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # q,o + k,v
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)              # causal QK, PV
    bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                   flops / BF16_FLOP_PER_S) * 1e3
    bound_by = ("bytes" if n_bytes / HBM_BYTES_PER_S
                >= flops / BF16_FLOP_PER_S else "operations")
    log(f"flash_attention @evaluator shape: kernel {timing['ms']:.4f} ms, "
        f"plain {timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} "
        f"ms (sdpa max abs err {lib_err:.3e}), bound {bound_ms:.4f} ms "
        f"({n_bytes} B, {flops} FLOP)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": timing["library_ms"]}


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------

def micro_batch(n: int, off: int, mk, fseed: int):
    keys = np.zeros(BATCH, np.uint32)
    keys[:n] = np.arange(off, off + n)
    buckets = np.zeros(BATCH, np.int32)
    return keys, buckets, mk(BATCH, fseed=fseed)


def phase_regime_parity(cfg: TrustIRConfig, evaluate, mk, dev) -> None:
    """Fused drain vs the host oracle on a SimClock at chunk-aligned
    Normal / Heavy / Very-Heavy loads, then a repeat that hits.

    Both monitors start from a measured evaluator rate of 2048 items/s
    (Ucapacity 1024, Uthreshold 1024). At the config's seed rate (4096
    items/s) Uthreshold is 2048 and Very Heavy would need more than 4096
    items, which one micro-batch cannot hold."""
    rate = 2048.0

    def monitor():
        m = LoadMonitor(cfg)
        m.observe(int(rate), 1.0)
        return m

    host = LoadShedder(cfg, evaluate, monitor=monitor(),
                       sim_clock=SimClock(rate), device=dev)
    fused = FusedLoadShedder(cfg, evaluate, monitor=monitor(),
                             sim_clock=SimClock(rate), device=dev)
    loads = [(768, Regime.NORMAL, 1), (1792, Regime.HEAVY, 100_001),
             (4096, Regime.VERY_HEAVY, 200_001), (768, None, 1)]
    worst = 0.0
    for n, regime, off in loads:
        keys, buckets, feats = micro_batch(n, off, mk, fseed=off)
        rh = host.process(keys, buckets, feats, n_valid=n)
        rf = fused.process(keys, buckets, feats, n_valid=n)
        if regime is not None and not rh.regime == rf.regime == regime:
            raise AssertionError(f"regime {rh.regime}/{rf.regime} at n={n}, "
                                 f"expected {regime}")
        if not np.array_equal(rh.tier, rf.tier):
            raise AssertionError(f"tiers differ at n={n}: "
                                 f"{int((rh.tier != rf.tier).sum())} items")
        counts_h = (rh.n_evaluated, rh.n_cached, rh.n_prior, rh.uload)
        counts_f = (rf.n_evaluated, rf.n_cached, rf.n_prior, rf.uload)
        if counts_h != counts_f:
            raise AssertionError(f"counts differ at n={n}: {counts_h} vs "
                                 f"{counts_f}")
        if not (np.isfinite(rf.trust).all() and (rf.trust[:n] >= 0).all()
                and (rf.trust <= cfg.trust_scale).all()):
            raise AssertionError("fused trust outside [0, trust_scale]")
        if (rf.tier[:n] == TIER_INVALID).any():
            raise AssertionError(f"an item was dropped at n={n}")
        err = float(np.abs(rh.trust - rf.trust).max())
        worst = max(worst, err)
        if err > TRUST_ATOL:
            raise AssertionError(f"trust differs at n={n}: {err}")
        log(f"  parity n={n} {rf.regime.name}: tiers equal, "
            f"evaluated {rf.n_evaluated} cached {rf.n_cached} prior "
            f"{rf.n_prior}, max |trust diff| {err:.3e}")
    if rf.n_cached < 0.9 * loads[-1][0]:
        raise AssertionError(f"repeat batch hit the Trust DB only "
                             f"{rf.n_cached} times")
    log(f"regime parity (SimClock, fused vs host LoadShedder): tiers and "
        f"counts exactly equal, max |trust diff| {worst:.3e} <= "
        f"{TRUST_ATOL}")


def phase_serving(cfg: TrustIRConfig, evaluate, mk, dev) -> dict:
    """DrainExecutor(depth=2) serves seeded micro-batches on the wall
    clock, then flushes. The launch counts are read around this run."""
    r = np.random.default_rng(SEED)
    n_batches = 8
    batches = []
    for i in range(n_batches):
        n = int(r.integers(BATCH // 2, BATCH + 1))
        keys = np.zeros(BATCH, np.uint32)
        # a third of each batch repeats keys already served
        keys[:n] = np.where(r.random(n) < 1 / 3,
                            r.integers(1, 1 + 4 * BATCH, n),
                            r.integers(1 << 20, 1 << 31, n)).astype(np.uint32)
        batches.append((i, keys, np.zeros(BATCH, np.int32),
                        mk(BATCH, fseed=1000 + i), n))

    class Batch:
        def __init__(self, i, keys, buckets, feats, n):
            self.i, self.item_keys, self.buckets = i, keys, buckets
            self.features, self.n_valid = feats, n

    # Dispatch must never wait for the card: under sync debug mode
    # "error" any implicit host-device sync in dispatch_staged raises.
    probe = FusedLoadShedder(cfg, evaluate, device=dev)
    _, keys, buckets, feats, n = batches[0]
    staged = probe.stage(keys, buckets, feats, n_valid=n)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = probe.dispatch_staged(staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending.result()
    log("dispatch_staged: no host-device sync under sync debug mode "
        "'error'")

    fused = FusedLoadShedder(cfg, evaluate, device=dev)
    results = {}

    def finalize(batch, shed):
        if batch.i in results:
            raise AssertionError(f"batch {batch.i} answered twice")
        results[batch.i] = shed
        return [batch.i]

    ex = DrainExecutor(fused, finalize, depth=2)
    torch.cuda.synchronize()
    shed_partition.launches = 0
    flash_attention.launches = 0
    t0 = time.monotonic()
    for b in batches:
        ex.submit(Batch(*b))
    ex.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"shed_partition": shed_partition.launches,
                "flash_attention": flash_attention.launches}

    if sorted(results) != list(range(n_batches)):
        raise AssertionError(f"answered {sorted(results)}")
    items = 0
    for i, _keys, _b, _f, n in batches:
        res = results[i]
        if (res.tier[:n] == TIER_INVALID).any() \
                or (res.tier[n:] != TIER_INVALID).any():
            raise AssertionError(f"batch {i} dropped an item")
        if not np.isfinite(res.trust).all() or res.trust.shape != (BATCH,):
            raise AssertionError(f"batch {i} trust malformed")
        items += n
    if launches["shed_partition"] != n_batches:
        raise AssertionError(f"shed_partition launched "
                             f"{launches['shed_partition']} times for "
                             f"{n_batches} batches")
    if launches["flash_attention"] != N_LAYERS * n_batches:
        raise AssertionError(f"flash_attention launched "
                             f"{launches['flash_attention']} times, "
                             f"expected {N_LAYERS * n_batches}")
    lat = np.array([results[i].response_time_s for i in range(n_batches)])
    stats = {"batches": n_batches, "items": items, "wall_s": wall,
             "items_per_s": items / wall,
             "p50_batch_latency_s": float(np.percentile(lat, 50)),
             "p99_batch_latency_s": float(np.percentile(lat, 99)),
             "regimes": [results[i].regime.name for i in range(n_batches)],
             "n_evaluated": [results[i].n_evaluated
                             for i in range(n_batches)],
             "n_cached": [results[i].n_cached for i in range(n_batches)],
             "launches": launches}
    log(f"serving (DrainExecutor depth 2, wall clock): {n_batches} batches, "
        f"{items} items in {wall:.3f} s = {stats['items_per_s']:.1f} items/s,"
        f" p50 batch latency {stats['p50_batch_latency_s'] * 1e3:.1f} ms, "
        f"p99 {stats['p99_batch_latency_s'] * 1e3:.1f} ms; regimes "
        f"{stats['regimes']}; launches {launches}")
    return stats


KERNEL_GROUPS = (
    ("shed_partition kernel", ("shed_partition_kernel",)),
    ("flash_attention kernel", ("flash_attention_kernel",)),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma", "cublas")),
    ("reductions (norms, logsumexp)", ("reduce", "softmax", "logsumexp")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def phase_profile(cfg: TrustIRConfig, evaluate, mk, dev) -> None:
    """Device time of one steady-state fused step by kernel group, and
    the card's busy share over the step's wall window (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fused = FusedLoadShedder(cfg, evaluate, device=dev)
    warm = micro_batch(BATCH, 300_001, mk, fseed=7)
    fused.process(*warm)
    keys, buckets, feats = micro_batch(BATCH, 400_001, mk, fseed=8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fused.process(keys, buckets, feats)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.device_time_total > 0]
    if not kernels:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, pats in KERNEL_GROUPS
                     if any(p in key for p in pats)), "other")
        groups[name] += e.device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    log(f"profile (one fused step, {BATCH} items, wall {wall * 1e3:.1f} ms):"
        f" device busy {busy_ms:.1f} ms = {busy_ms / (wall * 1e3):.3f} of "
        f"the window, {sum(e.count for e in kernels)} kernel launches")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {ms:.2f} ms ({ms / busy_ms:.3f})")
    for e in top:
        log(f"  top: {e.device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = card_line()
    log(f"card: {card}")
    phase_build()

    cfg = TrustIRConfig()
    kernels = [phase_shed_partition(cfg, dev), phase_flash_attention(dev)]

    t0 = time.monotonic()
    evaluate, mk = make_evaluator(cfg.evaluator_arch, smoke=False,
                                  seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"evaluator: full-width {cfg.evaluator_arch} "
        f"({N_LAYERS} layers, bf16) built in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    phase_regime_parity(cfg, evaluate, mk, dev)
    serving = phase_serving(cfg, evaluate, mk, dev)
    peak = torch.cuda.max_memory_allocated()
    log(f"peak device memory (parity + serving): {peak / 2 ** 30:.2f} GiB")
    phase_profile(cfg, evaluate, mk, dev)
    for kern in kernels:
        kern["launches"] = serving["launches"][kern["name"]]

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
