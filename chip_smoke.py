#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's five CUDA kernels from ``src/repro_torch/csrc`` in
parallel and holds each against its plain PyTorch version at the shapes
its path gives it:

* ``shed_partition``: Trust-DB probe, regime tiers, eval budget and
  compacted eval rank of one micro-batch (exact);
* ``flash_attention``: causal GQA attention of the transformer
  evaluator and of ``prefill``;
* ``topk_select``: the candidate set of one query (exact);
* ``dot_interaction``: the DLRM evaluator's pairwise feature dots;
* ``flash_decode``: one-token attention against the KV cache.

Then it drives these paths with seeded random weights, each with the
launch counts set to 0 just before it and read just after:

* the serving engine on a full-width smollm-135m evaluator (the main
  path, after the fused-drain phases): raw query strings -> BM25
  over a 65536-document corpus on the card -> ``topk_select`` ->
  admission -> EDF micro-batches -> fused shed (``shed_partition``,
  ``flash_attention``) -> responses, with retrieval checked against the
  Python BM25 oracle and a host-vs-fused engine parity run;
* the serve launcher's default scheduled mode: a ``ClusterCoordinator``
  of four replicas on the card (``configs.trust_ir``), each owning the
  doc-partition stripes the ring gives it, on the same evaluator and
  queries, with gossip and hedging on, a graceful leave and a join
  midway; then its host-vs-fused parity run, ``topk_select`` at every
  shard size the fleet built, the chaos trace replayed twice (equal
  fingerprints) and the paper's Fig 3.2 comparison (``ProcessAll``,
  ``RLSEDA``, ``LoadShedder``) on the wall clock;
* the same fleet with the tail-tolerant fan-out on SimClocks
  (``fanout``): first-3-of-4 quorum gather, shard-probe hedges onto
  mirror stripes, replica r0 slowed x8 for the middle of 480 queries so
  a mirror is built on its ring sibling, wins hedges and is dropped
  after the recovery; the mirror against r0, ``quorum_k == n`` against
  the plain gather, and a replay's fingerprint;
* the same engine on the full-width ``dlrm-mlperf`` evaluator
  (``dot_interaction``), its 26 tables capped at 20M rows to fit the
  card, and its host-vs-fused parity run;
* the same engine on the full-width ``bst``, ``mind`` and
  ``two-tower-retrieval`` evaluators in turn (``shed_partition`` and
  ``topk_select`` only; the two-tower tables capped at 20M rows), each
  with its host-vs-fused parity run and one profiled fused step;
* KV-cache decode on the smollm-135m weights: 128 prompts prefilled
  (``flash_attention``) into a 128-slot ``KVCachePool``, 64
  ``decode_step``s over the pool (``flash_decode``), decode logits
  checked against the full forward.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result.

Output: one line per phase; then the card's name and power limit (as
``nvidia-smi`` reports them), the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.

Numerics: TF32 is switched off for matmuls and cuDNN, so float32
products are full float32 and the tolerances below hold.
"""
from __future__ import annotations

import gc
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

from repro_torch.chaos import response_fingerprint  # noqa: E402
from repro_torch.cluster import (ClusterConfig,  # noqa: E402
                                 ClusterCoordinator)
from repro_torch.configs import TrustIRConfig, get_config  # noqa: E402
from repro_torch.configs import trust_ir  # noqa: E402
from repro_torch.configs.base import reduced  # noqa: E402
from repro_torch.core.baselines import RLSEDA, ProcessAll  # noqa: E402
from repro_torch.core import trust_cache as TC  # noqa: E402
from repro_torch.fanout import FanoutSearcher, ShardServiceModel  # noqa: E402
from repro_torch.core.deadline import effective_deadline  # noqa: E402
from repro_torch.core.fused_shedder import FusedLoadShedder  # noqa: E402
from repro_torch.core.load_monitor import LoadMonitor  # noqa: E402
from repro_torch.core.regimes import Regime  # noqa: E402
from repro_torch.core.shedder import (TIER_INVALID, LoadShedder,  # noqa: E402
                                      SimClock)
from repro_torch.configs.base import cap_table_rows  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.kernels.dot_interaction import (  # noqa: E402
    dot_interaction, dot_interaction_ref, group_size, triu_pairs)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_ref, piece_length)
from repro_torch.kernels.shed_partition import (  # noqa: E402
    shed_partition, shed_partition_ref)
from repro_torch.kernels.topk_select import (  # noqa: E402
    NEG_INF, TILE, launch_floor, staged_capacity, topk_select,
    topk_select_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.recsys import dlrm as dlrm_model  # noqa: E402
from repro_torch.models.recsys import embedding as E  # noqa: E402
from repro_torch.retrieval import (CorpusRetrieval, CorpusSearcher,  # noqa: E402
                                   IndexShard, SyntheticCorpus,
                                   ZipfQueryModel, topk_py)
from repro_torch.scheduling import Priority  # noqa: E402
from repro_torch.scheduling.executor import DrainExecutor  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.evaluators import make_evaluator  # noqa: E402
from repro_torch.serving.kv_cache import KVCachePool  # noqa: E402
from repro_torch.serving.simulator import (  # noqa: E402
    ChurnEvent, MultiTenantWorkload, TenantSpec, make_arrivals,
    run_churn_workload, run_cluster_workload, run_scheduled_workload)

# Every kernel wrapper of the port, each with its launch count.
KERNELS = {"shed_partition": shed_partition,
           "flash_attention": flash_attention,
           "topk_select": topk_select,
           "dot_interaction": dot_interaction,
           "flash_decode": flash_decode}

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores. The bound of a kernel
# is the larger of bytes / HBM rate and operations / peak rate for its
# type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

SEED = 0
BATCH = 4096                     # micro-batch capacity of the fused drain
ENGINE_BATCH = 3072              # ServingEngine's: Ucapacity + Uthreshold
DOC_LEN = 32                     # evaluator tokens per document (S = 31)
N_LAYERS = get_config("smollm-135m").n_layers
BF16_ATOL = 2e-2                 # kernel vs plain, bf16 output rounding
F32_ATOL = 1e-4                  # kernel vs plain, f32 summation order
TRUST_ATOL = 5e-2                # fused vs host drain (phase_regime_parity)
CORPUS_DOCS = 65536              # retrieval corpus of the main path
TOP_K = 64                       # TrustIRConfig.retrieve_top_k
ENGINE_QUERIES = 384             # main-path queries (8 micro-batches)
QUERIES_PER_DRAIN = ENGINE_BATCH // TOP_K   # 48 queries fill a batch
# dlrm-mlperf's Criteo-1TB tables hold 187,775,488 padded rows, 96.1 GB in
# float32, more than the card's 80 GB: every table is capped at 20M rows
# (MLPerf DLRM's --max-ind-range), which cuts 5 of the 26 tables and
# leaves 53.3 GB.
DLRM_ROW_CAP = 20_000_000
DLRM_TRUST_ATOL = 1e-4           # host vs fused drain, both float32
# The other recommenders at their published widths: BST (arXiv:1905.06874,
# 5.1M rows x 32, 0.65 GB) and MIND (arXiv:1904.08030, 11.0M rows x 64,
# 2.82 GB) as published; the two-tower model (RecSys'19) has 62M rows x
# 256 (63.5 GB), capped as DLRM at 20M rows a table: 32.0M rows, 32.8 GB.
RECSYS_ARCHS = (("bst", 0), ("mind", 0),
                ("two-tower-retrieval", DLRM_ROW_CAP))
RECSYS_TRUST_ATOL = 1e-4         # host vs fused drain, both float32
# KV-cache decode: decode_32k's global batch of slots (LM_SHAPES), the
# published context length of SmolLM-135M, prompts that leave room for
# the steps.
DECODE_SLOTS = 128
DECODE_MAX_LEN = 2048
DECODE_STEPS = 64
MAX_PROMPT = DECODE_MAX_LEN - DECODE_STEPS  # 1984
# decode vs full forward, both bf16: the two paths round at other places
# (GEMMs of (128, 576) vs (S, 576), the decode kernel's f32 combine vs the
# flash kernel's); logits have std ~0.5 and bf16 keeps 8 bits, while a
# wrong position or cache row moves them by O(1).
DECODE_LOGIT_ATOL = 0.1
# The serving fleet: the launcher's default scheduled mode on one card.
FLEET_REPLICAS = 4
FLEET_EXTRA_QUERIES = 96         # served after the leave and the join
FLEET_ORACLE_QUERIES = 16        # fleet searcher vs the Python BM25 oracle
# The fan-out fleet: the launcher's straggler demo (r0 slowed x8) on the
# fleet above, first 3 of 4 shards, shard-probe hedges after twice the
# service model's 4 ms base; 64 queries/s of top-64 arrivals, so one
# drain round (3072 items / 4096 items/s = 0.75 s) takes ~48 queries.
FANOUT_QUERIES = 480
FANOUT_QPS = 64.0
FANOUT_QUORUM_K = 3
FANOUT_HEDGE_AFTER_S = 0.008
FANOUT_STRAGGLE_MULT = 8.0
FANOUT_SLOW_AT, FANOUT_RECOVER_AT = 96, 288
# The chaos trace of the verify notes, as launcher flags (a 2 s trace on
# six replicas: flash crowd, query-of-death flood with the quarantine
# armed, a regional failure of two replicas, a rolling restart, epidemic
# gossip, hedging after 500 ms).
CHAOS_ARGV = ["--trace", "2", "--replicas", "6", "--chaos-flash", "4",
              "--chaos-poison", "3", "--quarantine-k", "3",
              "--chaos-crash", "2", "--chaos-restart", "--gossip",
              "--gossip-mode", "epidemic", "--hedge-after-ms", "500"]
# Paper Fig 3.2: the query "study in USA" returns 89,141 results in the
# paper's Nutch setup (benchmarks/bench_response_time.py).
PAPER_QUERY, PAPER_RESULTS = "study in USA", 89_141
PROCESS_ALL_MAX_S = 30.0         # ProcessAll's time cap: the count is cut


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


def l2_flusher(dev):
    """1 GiB written between timed launches evicts the 50 MB L2 (the
    main path's traffic does so between launches) and keeps the card
    busy (~0.3 ms) while the host enqueues the timed launch, so the
    events time the kernel, not the host's launch path."""
    scratch = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    return scratch.zero_


def max_err(got, want) -> float:
    if not got.numel():
        return 0.0
    return float((got.float() - want.float()).abs().max())


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
    logs = _build.build(list(KERNELS))
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


def shed_inputs(n: int, cached, gen, dev, mask: str = "prefix",
                offset: int = 0):
    """n probe keys, half of them cached (hits) and half fresh (misses),
    and their flags: the first 90% valid (``prefix``, as the drain pads a
    micro-batch) or 70% at random (``gapped``). With ``offset`` both are
    views that many elements into a larger buffer, so the kernel takes
    its unaligned load path."""
    m = n + offset
    pick = torch.randint(0, cached.shape[0], (m,), generator=gen,
                         device=dev)
    fresh = torch.randint(1, 2 ** 31 - 1, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
    keys = torch.where(torch.rand(m, generator=gen, device=dev) < 0.5,
                       cached[pick], fresh)
    if mask == "gapped":
        valid = torch.rand(m, generator=gen, device=dev) < 0.7
    else:
        valid = torch.arange(m, device=dev) < offset + n - n // 10
    return keys[offset:], valid[offset:]


def shed_cases():
    """(N, mask, offset) of every exact check: the first six as in earlier
    runs, then the round edges (1024 threads own 1, 2, 4 or 8 items each,
    so one round covers up to 8192), gapped masks and views at an offset
    of one element."""
    cases = [(n, "prefix", 0) for n in (0, 1, 1000, ENGINE_BATCH, BATCH,
                                        8192 + 37)]
    cases += [(n, "prefix", 0) for n in (1025, 2049, 4097, 8191, 8192,
                                         8193, 20000)]
    cases += [(n, "gapped", 0) for n in (1000, ENGINE_BATCH, BATCH, 8191,
                                         8193, 20000)]
    cases += [(n, mask, 1) for n in (1000, BATCH, 8193)
              for mask in ("prefix", "gapped")]
    return cases


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
    max_err, n_checked = 0.0, 0
    timed = {}
    cases = shed_cases()
    for n, mask, offset in cases:
        keys, valid = shed_inputs(n, cached, gen, dev, mask, offset)
        n_valid = int(valid.sum())
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
                            f"version at N={n} {mask} offset {offset} "
                            f"{layout} budget_is_total={total}: {bad} items")
                n_checked += 1
                if n:
                    max_err = max(max_err, float(
                        (got[1] - want[1]).abs().max()))
        if (mask, offset) == ("prefix", 0) and n in (ENGINE_BATCH, BATCH):
            timed[n] = (keys, valid, budget_total)
    log(f"shed_partition: {n_checked} cases exactly equal to the plain "
        f"version (N, mask, offset: "
        f"{'; '.join(f'{n} {m} {o}' for n, m, o in cases)}; both layouts; "
        f"both budget modes)")

    ck, cv = layouts["ways-leading"]
    flush = l2_flusher(dev)                   # the Trust DB arrives cold
    ms = {}
    for n, (keys, valid, budget) in timed.items():
        args = (keys, valid, ck, cv, ucap, uthr, budget)
        ms[n] = timed_ms(lambda: shed_partition(*args, budget_is_total=True),
                         200, flush)
    keys, valid, budget = timed[BATCH]
    args = (keys, valid, ck, cv, ucap, uthr, budget)
    plain_ms = timed_ms(lambda: shed_partition_ref(
        *args, budget_is_total=True), 50, flush)
    floor_ms = timed_ms(lambda: launch_floor(dev), 200, flush)
    n_bytes = shed_bytes(keys, valid, ck, cv)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    log(f"shed_partition @N={BATCH}: kernel {ms[BATCH]:.4f} ms, "
        f"@N={ENGINE_BATCH}: {ms[ENGINE_BATCH]:.4f} ms; plain "
        f"{plain_ms:.4f} ms; launch floor (an empty kernel through the same "
        f"ctypes route) {floor_ms:.4f} ms; bound {bound_ms:.7f} ms "
        f"({n_bytes} B)")
    return {"name": "shed_partition", "route": "cuda",
            "source": "src/repro_torch/csrc/shed_partition.cu",
            "replaces": "src/repro/kernels/shed_partition.py:200",
            "max_abs_err": max_err, "ms": ms[BATCH], "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "n3072_ms": ms[ENGINE_BATCH], "launch_floor_ms": floor_ms}


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

    q3, k3, v3 = attention_inputs(ENGINE_BATCH, S, Hq, Hkv, D,
                                  torch.bfloat16, gen, dev)
    err3 = float((flash_attention(q3, k3, v3, causal=True).float()
                  - flash_attention_ref(q3, k3, v3, causal=True).float())
                 .abs().max())
    if err3 > BF16_ATOL:
        raise AssertionError(f"flash_attention bf16 B={ENGINE_BATCH}: max "
                             f"abs err {err3} > {BF16_ATOL}")
    log(f"flash_attention bf16 at the engine's batch (B={ENGINE_BATCH}): "
        f"max abs err {err3:.3e} <= {BF16_ATOL}")
    err = max(err, err3)

    smoke = get_config("smollm-135m", smoke=True)   # serve's evaluator
    q4, k4, v4 = attention_inputs(64, S, smoke.n_heads, smoke.n_kv_heads,
                                  smoke.d_head, torch.float32, gen, dev)
    err4 = float((flash_attention(q4, k4, v4, causal=True)
                  - flash_attention_ref(q4, k4, v4, causal=True)).abs().max())
    if err4 > F32_ATOL:
        raise AssertionError(f"flash_attention f32 D={smoke.d_head}: max abs "
                             f"err {err4} > {F32_ATOL}")
    log(f"flash_attention f32 at the smoke evaluator's shape (B=64, S={S}, "
        f"{smoke.n_heads}/{smoke.n_kv_heads} heads, D={smoke.d_head}): max "
        f"abs err {err4:.3e} <= {F32_ATOL}")

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

    # prefill of the decode phase's longest prompt: B 1, S 1984
    q5, k5, v5 = attention_inputs(1, MAX_PROMPT, Hq, Hkv, D, torch.bfloat16,
                                  gen, dev)
    want5 = flash_attention_ref(q5, k5, v5, causal=True)
    err5 = max_err(flash_attention(q5, k5, v5, causal=True), want5)
    if err5 > BF16_ATOL:
        raise AssertionError(f"flash_attention bf16 prefill S={MAX_PROMPT}: "
                             f"max abs err {err5} > {BF16_ATOL}")
    log(f"flash_attention bf16 at the prefill shape (B=1, S={MAX_PROMPT}, "
        f"causal): max abs err {err5:.3e} <= {BF16_ATOL}")
    err = max(err, err5)

    flush = l2_flusher(dev)            # the main path finds q, k, v cold
    timing = attention_timing(q, k, v, flush, plain_iters=5)
    log(f"flash_attention @evaluator shape: kernel {timing['ms']:.4f} ms, "
        f"plain {timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} "
        f"ms (sdpa max abs err {max_err(timing['library_out'], want):.3e}), "
        f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{timing['bytes']} B, {timing['flops']} FLOP)")
    prefill = attention_timing(q5, k5, v5, flush, plain_iters=0)
    log(f"flash_attention @prefill shape (B=1, S={MAX_PROMPT}): kernel "
        f"{prefill['ms']:.4f} ms, sdpa {prefill['library_ms']:.4f} ms (sdpa "
        f"max abs err {max_err(prefill['library_out'], want5):.3e}), bound "
        f"{prefill['bound_ms']:.6f} ms ({prefill['bound_by']}: "
        f"{prefill['bytes']} B, {prefill['flops']} FLOP)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            "max_abs_err": err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "library_ms": timing["library_ms"],
            "prefill_ms": prefill["ms"],
            "prefill_library_ms": prefill["library_ms"],
            "prefill_bound_ms": prefill["bound_ms"]}


def attention_timing(q, k, v, flush, plain_iters: int) -> dict:
    """Causal bf16 attention at one shape: the kernel, SDPA (GQA) and,
    with ``plain_iters``, the plain version, each with L2 flushed between
    launches; the bound from the bytes of q, k, v, o and the causal
    FLOPs."""
    B, S, Hq, D = q.shape

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True)

    n_bytes = 2 * (q.numel() * 2 + k.numel() + v.numel())   # q,o + k,v
    flops = 4 * B * Hq * D * (S * (S + 1) // 2)              # causal QK, PV
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {
        "ms": timed_ms(lambda: flash_attention(q, k, v, causal=True), 20,
                       flush),
        "plain_ms": (timed_ms(lambda: flash_attention_ref(q, k, v,
                                                          causal=True),
                              plain_iters, flush) if plain_iters else None),
        "library_ms": timed_ms(library, 20, flush),
        "library_out": library().transpose(1, 2),
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bytes": n_bytes, "flops": flops}


# ---------------------------------------------------------------------------
# phase 5: topk_select against its plain version
# ---------------------------------------------------------------------------

def edge_scores(kind, n, dtype, gen, dev):
    """Scores for the edges of the cluster radix select: the k-th score
    tied at every 32nd place (so across every CTA) under 40 higher ones;
    a third of the scores tied under 10 higher ones; BM25-shaped scores,
    non-negative with 90% exact zeros and repeated values."""
    u = torch.rand(n, generator=gen, device=dev, dtype=torch.float64)
    if kind == "tied_kth":
        s = u * 0.5
        s[7::32] = 1.5
        s[torch.randperm(n, generator=gen, device=dev)[:40]] = 2.0 + u[:40]
    elif kind == "ties_above_k":
        s = u * 0.5
        s[u < 1 / 3] = 1.0
        s[torch.randperm(n, generator=gen, device=dev)[:10]] = 3.0
    else:                                           # "bm25"
        s = torch.where(u < 0.9, torch.zeros_like(u),
                        torch.round(-torch.log(u) * 64) / 8)
    return s.to(dtype)


def topk_cases(gen, dev):
    """(label, scores, k): the main path's shape (float64 BM25 scores of
    the 65536-document shard), the TPU kernel's float32 shapes, then the
    edges."""
    def randn(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device=dev, dtype=dtype)

    def edge(kind, n, dtype=torch.float64):
        return edge_scores(kind, n, dtype, gen, dev)

    zeros = torch.zeros(CORPUS_DOCS, device=dev)
    zeros[torch.rand(CORPUS_DOCS, generator=gen, device=dev) < 0.5] = -0.0
    pick = torch.rand(CORPUS_DOCS, generator=gen, device=dev)
    zeros[pick < 0.05] = 1.0
    zeros[pick > 0.95] = -1.0
    # float64 scores one ulp apart that one float32 would tie
    base = torch.randint(0, 50, (CORPUS_DOCS,), generator=gen,
                         device=dev).double()
    near = torch.where(torch.rand(CORPUS_DOCS, generator=gen,
                                  device=dev) < 0.5,
                       torch.nextafter(base, base + 1), base)
    f32, f64 = torch.float32, torch.float64
    cap32, cap64 = staged_capacity(f32), staged_capacity(f64)
    half32, half64 = TILE[f32] // 2, TILE[f64] // 2
    return [
        ("main path f64 N=65536 k=64", randn(CORPUS_DOCS, f64), TOP_K),
        ("f32 N=65536 k=64", randn(CORPUS_DOCS), TOP_K),
        ("f32 shard of a million N=1048576 k=64", randn(1 << 20), TOP_K),
        ("N=1", randn(1), 1),
        ("N=1000 k=N", randn(1000), 1000),
        ("ragged N=70001 k=64", randn(70_001), TOP_K),
        ("ragged N=4097 k=3", randn(4097), 3),
        ("all NEG_INF N=65536 k=64",
         torch.full((CORPUS_DOCS,), NEG_INF, device=dev), TOP_K),
        ("duplicates N=65536 k=64 (5 distinct scores)",
         torch.randint(0, 5, (CORPUS_DOCS,), generator=gen,
                       device=dev).float(), TOP_K),
        ("+0.0 mixed with -0.0 N=65536 k=64", zeros, TOP_K),
        ("+0.0 mixed with -0.0 f64", zeros.double(), TOP_K),
        ("f64 near-ties N=65536 k=64", near, TOP_K),
        ("k-th score tied across every CTA f64 k=TILE/2",
         edge("tied_kth", CORPUS_DOCS), half64),
        ("k-th score tied across every CTA f32 k=TILE/2",
         edge("tied_kth", CORPUS_DOCS, f32), half32),
        ("k-th score tied across every CTA f64 k=64",
         edge("tied_kth", CORPUS_DOCS), TOP_K),
        ("ties at T more than k f64 N=65536 k=64",
         edge("ties_above_k", CORPUS_DOCS), TOP_K),
        ("ties at T more than k f32 N=70001 k=7",
         edge("ties_above_k", 70_001, f32), 7),
        ("f64 N=staged capacity-1", randn(cap64 - 1, f64), TOP_K),
        ("f64 N=staged capacity+1", randn(cap64 + 1, f64), TOP_K),
        ("f32 N=staged capacity-1", randn(cap32 - 1), TOP_K),
        ("f32 N=staged capacity+1", randn(cap32 + 1), TOP_K),
        ("f64 N=262144 k=64", randn(1 << 18, f64), TOP_K),
        ("f64 k=TILE/2+1 (full sort)", randn(CORPUS_DOCS, f64), half64 + 1),
        ("f32 k=TILE/2 N=65536", randn(CORPUS_DOCS), half32),
        ("f32 k=TILE/2+1 (full sort)", randn(CORPUS_DOCS), half32 + 1),
        ("BM25-shaped f64 N=65536 k=64", edge("bm25", CORPUS_DOCS), TOP_K),
        ("full sort N=10000 k=5000", randn(10_000), 5000),
        ("full sort f64 N=10000 k=10000", randn(10_000, f64), 10_000),
        ("full sort N=1048576 k=3000 (duplicates)",
         torch.randint(0, 100, (1 << 20,), generator=gen,
                       device=dev).float(), 3000),
    ]


def topk_timing(scores, k, flush) -> dict:
    n, size = scores.shape[0], scores.element_size()
    n_bytes = n * size + k * (size + 4)          # read N, write k values+ids
    return {
        "ms": timed_ms(lambda: topk_select(scores, k), 200, flush),
        "plain_ms": timed_ms(lambda: topk_select_ref(scores, k), 50, flush),
        "library_ms": timed_ms(lambda: torch.topk(scores, k), 200, flush),
        "bytes": n_bytes,
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
    }


def phase_topk_select(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = topk_cases(gen, dev)
    for label, scores, k in cases:
        bits = torch.int64 if scores.dtype == torch.float64 else torch.int32
        want_v, want_i = topk_select_ref(scores, k)
        runs = [topk_select(scores, k) for _ in range(2)]
        torch.cuda.synchronize()
        for got_v, got_i in runs:
            if not torch.equal(got_i, want_i):
                bad = int((got_i != want_i).sum())
                raise AssertionError(f"topk_select indices differ from the "
                                     f"plain version ({label}): {bad} of {k}")
            if got_v.dtype != scores.dtype or not torch.equal(
                    got_v.view(bits), want_v.view(bits)):
                raise AssertionError(f"topk_select values differ from the "
                                     f"plain version ({label})")
    log(f"topk_select: {len(cases)} cases exactly equal to the plain "
        f"version, values bit for bit, two calls each with the same bits "
        f"({'; '.join(c[0] for c in cases)})")
    flush = l2_flusher(dev)
    timings = {label: topk_timing(scores, k, flush)
               for label, scores, k in cases[:3]}
    for label, t in timings.items():
        log(f"topk_select @{label}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, torch.topk {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.6f} ms ({t['bytes']} B)")
    floor_ms = timed_ms(lambda: launch_floor(dev), 200, flush)
    log(f"topk_select: launch floor (an empty kernel through the same ctypes "
        f"route) {floor_ms:.4f} ms")
    t = timings[cases[0][0]]
    return {"name": "topk_select", "route": "cuda",
            "source": "src/repro_torch/csrc/topk_select.cu",
            "replaces": "src/repro/kernels/topk_select.py:111",
            "max_abs_err": 0.0, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": t["library_ms"], "launch_floor_ms": floor_ms,
            "f32_ms": timings[cases[1][0]]["ms"],
            "f32_1m_ms": timings[cases[2][0]]["ms"]}


# ---------------------------------------------------------------------------
# phase 5b: dot_interaction against its plain version
# ---------------------------------------------------------------------------

DLRM_F, DLRM_D = 27, 128         # dlrm-mlperf: 26 tables + the bottom MLP


def phase_dot_interaction(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    # the engine's shapes, then the group walk's edges: fewer samples
    # than SMs, B not a multiple of the group (F 8 groups six samples), a
    # run that starts unaligned (F 63 in bf16), F 1 and 2, odd D, x not
    # 16-byte aligned (the last)
    shapes = [(b, DLRM_F, DLRM_D) for b in (1, 37, ENGINE_BATCH, BATCH)] \
        + [(37, 27, 128), (128, 27, 128), (16, 8, 64), (5, 12, 32),
           (4097, 8, 64), (45, 63, 64), (40, 1, 128), (300, 2, 128),
           (33, 27, 127), (50, 27, 128)]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    inputs = {}
    for dtype, atol in ((torch.float32, F32_ATOL),
                        (torch.bfloat16, BF16_ATOL)):
        for i, (B, Fn, D) in enumerate(shapes):
            # the model's scale: rows of norm ~1, as the 1/sqrt(D) tables
            flat = (torch.randn(B * Fn * D + 1, generator=gen, device=dev)
                    * D ** -0.5).to(dtype)
            skew = int(i == len(shapes) - 1)
            x = flat[skew:skew + B * Fn * D].view(B, Fn, D)
            got = dot_interaction(x)
            want = dot_interaction_ref(x)
            torch.cuda.synchronize()
            err = max_err(got, want)
            if got.shape != want.shape or got.dtype != dtype \
                    or not torch.isfinite(got).all() or err > atol:
                raise AssertionError(f"dot_interaction {dtype} B={B} F={Fn} "
                                     f"D={D}: max abs err {err} > {atol}")
            worst[dtype] = max(worst[dtype], err)
            inputs[(B, Fn, D, dtype)] = x
    groups = {f"F {f} {str(dt).split('.')[1]}": group_size(f, d, dt)
              for f, d in ((DLRM_F, DLRM_D), (8, 64))
              for dt in (torch.float32, torch.bfloat16)}
    log(f"dot_interaction: {len(shapes)} shapes x 2 dtypes ({shapes}, the "
        f"last with x one element off 16-byte alignment; samples a group: "
        f"{groups}) within "
        f"tolerance of the plain version (f32 max abs err "
        f"{worst[torch.float32]:.3e} <= {F32_ATOL}, bf16 "
        f"{worst[torch.bfloat16]:.3e} <= {BF16_ATOL})")
    flush = l2_flusher(dev)
    iu, ju = triu_pairs(DLRM_F, dev)

    def yardstick(x):                  # two library calls: bmm, gather
        return torch.bmm(x, x.transpose(1, 2))[:, iu, ju]

    rows = {}
    for B in (ENGINE_BATCH, BATCH):
        x = inputs[(B, DLRM_F, DLRM_D, torch.float32)]
        n_pairs = DLRM_F * (DLRM_F - 1) // 2
        n_bytes = (x.numel() + B * n_pairs) * 4
        flops = 2 * B * n_pairs * DLRM_D
        t = {"ms": timed_ms(lambda: dot_interaction(x), 200, flush),
             "plain_ms": timed_ms(lambda: dot_interaction_ref(x), 100,
                                  flush),
             "yardstick_ms": timed_ms(lambda: yardstick(x), 100, flush),
             # one read-only pass over the input: the floor a kernel that
             # reads these bytes meets under the same flush
             "read_ms": timed_ms(lambda: x.sum(), 100, flush),
             "bound_ms": max(n_bytes / HBM_BYTES_PER_S,
                             flops / F32_FLOP_PER_S) * 1e3,
             "bound_by": ("bytes" if n_bytes / HBM_BYTES_PER_S
                          >= flops / F32_FLOP_PER_S else "operations")}
        rows[B] = t
        log(f"dot_interaction @B={B} F={DLRM_F} D={DLRM_D} f32: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.bmm + "
            f"triangle gather (two library calls) {t['yardstick_ms']:.4f} "
            f"ms, one read-only pass over x (torch.sum) {t['read_ms']:.4f} "
            f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {n_bytes} "
            f"B, {flops} FLOP)")
    t = rows[ENGINE_BATCH]             # the DLRM engine's micro-batch
    return {"name": "dot_interaction", "route": "cuda",
            "source": "src/repro_torch/csrc/dot_interaction.cu",
            "replaces": "src/repro/kernels/dot_interaction.py:48",
            "max_abs_err": max(worst.values()), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "b4096_ms": rows[BATCH]["ms"],
            "yardstick_ms": t["yardstick_ms"], "read_ms": t["read_ms"]}


# ---------------------------------------------------------------------------
# phase 5c: flash_decode against its plain version
# ---------------------------------------------------------------------------

def decode_inputs(B, L, Hq, Hkv, D, dtype, gen, dev):
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, L, Hkv, D), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    return q, k, v


def check_decode(q, k, v, lengths, window, softcap, label) -> float:
    atol = F32_ATOL if q.dtype == torch.float32 else BF16_ATOL
    got = flash_decode(q, k, v, lengths, window=window, softcap=softcap)
    want = flash_decode_ref(q, k, v, lengths, window=window,
                            softcap=softcap)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if got.dtype != q.dtype or not torch.isfinite(got).all() or err > atol:
        raise AssertionError(f"flash_decode {label}: max abs err {err} > "
                             f"{atol}")
    return err


def phase_flash_decode(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    lm = get_config("smollm-135m")
    B, L, Hq, Hkv, D = DECODE_SLOTS, DECODE_MAX_LEN, lm.n_heads, \
        lm.n_kv_heads, lm.d_head
    cases = [(3, 512, 4, 2, 64, 0, 0.0), (2, 512, 8, 1, 128, 100, 30.0),
             (2, 256, 8, 8, 64, 0, 0.0), (1, 1024, 9, 3, 64, 0, 0.0),
             (B, L, Hq, Hkv, D, 0, 0.0), (B, L, Hq, Hkv, D, 256, 30.0)]
    worst, n_checks = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for b, l, hq, hkv, d, win, cap in cases:
            q, k, v = decode_inputs(b, l, hq, hkv, d, dtype, gen, dev)
            steps = torch.as_tensor(np.arange(b) * (l // b) % l + 1,
                                    dtype=torch.int32, device=dev)
            ragged = torch.randint(1, l + 1, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
            edges = torch.tensor([1, l, 0, l - 1], dtype=torch.int32,
                                 device=dev)[:b]
            ragged[:edges.numel()] = edges
            one_long = torch.ones(b, dtype=torch.int32, device=dev)
            one_long[b // 2] = l
            for lengths in (steps, ragged, one_long):
                label = (f"{dtype} B={b} L={l} {hq}/{hkv} heads D={d} "
                         f"window={win} softcap={cap}")
                worst = max(worst, check_decode(q, k, v, lengths, win, cap,
                                                label))
                n_checks += 1
            zero = torch.zeros(b, dtype=torch.int32, device=dev)
            if flash_decode(q, k, v, zero, window=win, softcap=cap).any():
                raise AssertionError(f"flash_decode {label}: length 0 "
                                     f"gave nonzero output")
    # the poison check of tests/test_kernels.py: positions past the length
    # must not reach the output
    q, k, v = decode_inputs(2, 256, 4, 4, 64, torch.float32, gen, dev)
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=dev)
    out1 = flash_decode(q, k, v, lengths)
    k[:, 200:], v[:, 200:] = 1e4, -1e4
    if not torch.equal(flash_decode(q, k, v, lengths), out1):
        raise AssertionError("flash_decode read past the lengths")
    log(f"flash_decode: {n_checks} cases within tolerance of the plain "
        f"version (the four reference cases and the decode shape, f32 and "
        f"bf16, lengths 1..L, 1, L, L-1 and 0, one row at L and the rest at "
        f"1), max abs err {worst:.3e}; "
        f"length 0 gives zeros; the poison check holds")

    q, k, v = decode_inputs(B, L, Hq, Hkv, D, torch.bfloat16, gen, dev)
    flush = l2_flusher(dev)
    lengths = torch.randint(1, L + 1, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
    t = decode_timing(q, k, v, lengths, flush, plain_iters=20)
    log(f"flash_decode @decode shape (B={B}, L={L}, {Hq}/{Hkv} heads, D={D}, "
        f"bf16, mean length {t['mean_length']:.0f}, pieces of "
        f"{t['piece']}): kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, sdpa with a length mask "
        f"{t['library_ms']:.4f} ms (max abs err {t['library_err']:.3e}), "
        f"bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {t['bytes']} B, "
        f"{t['flops']} FLOP)")
    full = decode_timing(q, k, v, torch.full((B,), L, dtype=torch.int32,
                                             device=dev), flush, 0)
    log(f"flash_decode @decode shape, every row at length {L}: kernel "
        f"{full['ms']:.4f} ms, sdpa with a length mask "
        f"{full['library_ms']:.4f} ms (max abs err "
        f"{full['library_err']:.3e}), bound {full['bound_ms']:.6f} ms "
        f"({full['bound_by']}: {full['bytes']} B)")
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:83",
            "max_abs_err": worst, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "full_ms": full["ms"], "full_library_ms": full["library_ms"],
            "full_bound_ms": full["bound_ms"]}


def decode_timing(q, k, v, lengths, flush, plain_iters: int) -> dict:
    """The decode kernel, SDPA with a boolean length mask and, with
    ``plain_iters``, the plain version at one set of lengths, L2 flushed
    between launches; the bound from the valid cache rows' bytes."""
    B, L, Hkv, D = k.shape
    Hq = q.shape[1]
    pos = torch.arange(L, device=q.device)
    mask = (pos[None, :] < lengths[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    n_valid = int(lengths.sum())
    n_bytes = (n_valid * Hkv * D * 2 * 2           # valid k and v rows
               + 2 * q.numel() * 2 + B * 4)        # q, o, lengths
    flops = 4 * n_valid * Hq * D                    # QK and PV
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return {
        "ms": timed_ms(lambda: flash_decode(q, k, v, lengths), 200, flush),
        "plain_ms": (timed_ms(lambda: flash_decode_ref(q, k, v, lengths),
                              plain_iters, flush) if plain_iters else None),
        "library_ms": timed_ms(library, 100, flush),
        "library_err": max_err(library(), flash_decode_ref(q, k, v,
                                                           lengths)),
        "piece": piece_length(B, Hkv, L, q.dtype, D),
        "mean_length": n_valid / B,
        "bound_ms": max(by_bytes, by_ops) * 1e3,
        "bound_by": "bytes" if by_bytes >= by_ops else "operations",
        "bytes": n_bytes, "flops": flops}


# ---------------------------------------------------------------------------
# phase 6: the fused drain at full width (the first slice's path)
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
    ("flash_attention kernel", ("flash_attention_bf16_kernel",
                                "flash_attention_f32_kernel")),
    ("dot_interaction kernel", ("dot_interaction_kernel",)),
    ("flash_decode kernel", ("flash_decode_pieces_kernel",
                             "flash_decode_combine_kernel")),
    ("GEMM (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma", "cublas")),
    ("reductions (norms, logsumexp)", ("reduce", "softmax", "logsumexp")),
    ("gather / scatter / index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def device_profile(label: str, fn):
    """Device time of one call of ``fn`` by kernel group, and the card's
    busy share over the call's wall window (torch.profiler; the
    profiler's own host cost inflates the wall, so the share is a lower
    bound). Returns the wall, busy time, share and launch count, or
    None when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.device_time_total > 0]
    if not kernels:
        log(f"profile ({label}): the profiler recorded no device time (not "
            f"measured)")
        return None
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        name = next((g for g, pats in KERNEL_GROUPS
                     if any(p in key for p in pats)), "other")
        groups[name] += e.device_time_total / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    log(f"profile ({label}, wall {wall * 1e3:.1f} ms): device busy "
        f"{busy_ms:.1f} ms = {busy_ms / (wall * 1e3):.3f} of the window, "
        f"{sum(e.count for e in kernels)} kernel launches")
    for name, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        if ms > 0:
            log(f"  {name}: {ms:.2f} ms ({ms / busy_ms:.3f})")
    for e in top:
        log(f"  top: {e.device_time_total / 1e3:8.3f} ms x{e.count:<5d} "
            f"{e.key[:90]}")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "busy_share": busy_ms / (wall * 1e3),
            "launches": sum(e.count for e in kernels)}


def phase_profile(cfg: TrustIRConfig, evaluate, mk, dev) -> None:
    """One steady-state fused step of the smollm evaluator."""
    fused = FusedLoadShedder(cfg, evaluate, device=dev)
    warm = micro_batch(BATCH, 300_001, mk, fseed=7)
    fused.process(*warm)
    keys, buckets, feats = micro_batch(BATCH, 400_001, mk, fseed=8)
    device_profile(f"one fused step, {BATCH} items",
                   lambda: fused.process(keys, buckets, feats))


# ---------------------------------------------------------------------------
# phase 7: retrieval on the card against the Python BM25 oracle
# ---------------------------------------------------------------------------

def build_retrieval(cfg: TrustIRConfig, mk, dev):
    """The corpus of the main path, its collection statistics, and one
    shard owning all partitions on the card; ``feature_fn`` maps each
    retrieved candidate set to evaluator tokens, as the serve launcher
    does."""
    def doc_features(docs):
        return mk(len(docs), fseed=int(docs[0]) % 1_000_000
                  if len(docs) else 0)

    t0 = time.monotonic()
    corpus = SyntheticCorpus(n_docs=cfg.corpus_docs,
                             vocab_size=cfg.corpus_vocab,
                             zipf_a=cfg.corpus_zipf_a, seed=cfg.corpus_seed)
    t1 = time.monotonic()
    retrieval = CorpusRetrieval(corpus, n_partitions=cfg.index_partitions,
                                block_docs=cfg.index_block_docs,
                                feature_fn=doc_features, device=dev)
    shard = retrieval.build_shard(range(cfg.index_partitions))
    t2 = time.monotonic()
    shard._ensure_dense()
    torch.cuda.synchronize()
    t3 = time.monotonic()
    log(f"retrieval: corpus of {corpus.n_docs} docs (vocab "
        f"{corpus.vocab_size}, Zipf {corpus.zipf_a}) built in "
        f"{t1 - t0:.1f} s on the host; statistics + index of "
        f"{cfg.index_partitions} partitions in {t2 - t1:.1f} s; dense form "
        f"on the card in {t3 - t2:.1f} s")
    return corpus, retrieval, shard


def phase_retrieval(corpus, retrieval, shard, dev) -> None:
    if shard._w_dense is not None:
        raise AssertionError("expected the postings-scatter form at "
                             f"{corpus.n_docs} docs")
    n_bytes = sum(t.numel() * t.element_size()
                  for t in (shard._post_slot, shard._post_w))
    log(f"retrieval: scatter form {tuple(shard._post_slot.shape)} int32 + "
        f"f64 = {n_bytes / 1e9:.3f} GB on the card")
    cpu = IndexShard(shard.index, k1=shard.k1, b=shard.b,
                     stats=shard.stats, device="cpu")
    qm = ZipfQueryModel.for_corpus(corpus, seed=SEED + 1)
    queries = [qm.sample() for _ in range(64)]
    n_docs, t_card = 0, 0.0
    for q in queries:
        t0 = time.monotonic()
        docs, scores = shard.retrieve(q, TOP_K)
        t_card += time.monotonic() - t0
        want = topk_py(shard.score_py(q), TOP_K)
        if docs.tolist() != [d for d, _ in want]:
            raise AssertionError(f"retrieval ids differ from the Python "
                                 f"oracle for {q!r}")
        # float64 BM25 in the oracle's own order: the same bits
        if scores.tolist() != [x for _, x in want]:
            raise AssertionError(f"retrieval scores differ from the "
                                 f"Python oracle for {q!r}")
        docs_c, scores_c = cpu.retrieve(q, TOP_K)
        if docs_c.tolist() != docs.tolist() \
                or scores_c.tolist() != scores.tolist():
            raise AssertionError(f"retrieval on the card differs from the "
                                 f"CPU shard for {q!r}")
        n_docs += len(docs)
    log(f"retrieval: 64 queries, {n_docs} candidates: ids and float64 "
        f"scores equal to the Python oracle and to the CPU shard, bit for "
        f"bit; "
        f"{t_card / len(queries) * 1e3:.3f} ms per query on the card "
        f"(BM25 + topk_select + one copy to the host)")


# ---------------------------------------------------------------------------
# phase 8: ServingEngine end to end (the main path)
# ---------------------------------------------------------------------------

def engine_queries(corpus, seed: int, n: int):
    qm = ZipfQueryModel.for_corpus(corpus, seed=seed)
    r = np.random.default_rng(seed)
    prios = r.choice(4, size=n, p=[0.1, 0.2, 0.5, 0.2])
    return [(qm.sample(), Priority(int(p)), f"tenant{i % 4}")
            for i, p in enumerate(prios)]


class TimedSearcher:
    """A searcher that sums the retrieve time of the one it wraps."""

    def __init__(self, inner):
        self.inner, self.total_s = inner, 0.0

    def search(self, query, n_results):
        res = self.inner.search(query, n_results)
        self.total_s += self.inner.last_retrieve_s
        return res


def serve_queries(eng, queries) -> list:
    rids = []
    for i, (q, prio, tenant) in enumerate(queries):
        rids.append(eng.enqueue_query(q, priority=prio, tenant=tenant))
        if (i + 1) % QUERIES_PER_DRAIN == 0:
            eng.drain(1)
    eng.flush()
    return rids


class CountedEvaluator:
    """The evaluator with a count of its forward calls."""

    def __init__(self, evaluate):
        self.evaluate, self.calls = evaluate, 0

    def __call__(self, chunk):
        self.calls += 1
        return self.evaluate(chunk)


def phase_engine(cfg: TrustIRConfig, searcher, evaluate, dev, label: str,
                 expect) -> dict:
    """384 seeded queries through ``ServingEngine.enqueue_query`` with a
    drain of one micro-batch every 48 queries, on the wall clock, after
    one warm-up round. Every launch count is set to 0 just before the
    measured run and read just after; ``expect(n_searches, n_batches)``
    gives the count each kernel must show."""
    timed = TimedSearcher(searcher)
    eng = ServingEngine(cfg, evaluate, retriever=timed, device=dev)
    sched = eng.scheduler
    if sched.max_batch_items != ENGINE_BATCH:
        raise AssertionError(f"micro-batch capacity {sched.max_batch_items}"
                             f", expected {ENGINE_BATCH}")
    serve_queries(eng, engine_queries(searcher.corpus, SEED + 4,
                                      QUERIES_PER_DRAIN))
    eng.completed.clear()
    base = sched.stats.as_dict()
    queries = engine_queries(searcher.corpus, SEED + 3, ENGINE_QUERIES)
    n_search0, timed.total_s = searcher.n_searches, 0.0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    if isinstance(evaluate, CountedEvaluator):
        evaluate.calls = 0
    t0 = time.monotonic()
    rids = serve_queries(eng, queries)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: w.launches for name, w in KERNELS.items()}

    st = sched.stats.as_dict()
    n_batches = st["n_batches"] - base["n_batches"]
    n_items = st["n_batched_items"] - base["n_batched_items"]
    n_searches = searcher.n_searches - n_search0
    answered = [r.request_id for r in eng.completed]
    if sorted(answered) != sorted(rids) or len(set(answered)) != len(rids):
        raise AssertionError(f"{len(rids)} requests, {len(answered)} "
                             f"answers, {len(set(answered))} distinct")
    for r in eng.completed:
        if not np.isfinite(r.trust).all() or len(r.trust) != len(r.tier):
            raise AssertionError(f"request {r.request_id}: trust malformed")
        if (r.tier == TIER_INVALID).any():
            raise AssertionError(f"request {r.request_id} dropped an item")
        if not r.admitted and not r.reason:
            raise AssertionError(f"request {r.request_id} rejected without "
                                 f"a reason")
    want = expect(n_searches, n_batches)
    if launches != want or n_searches != ENGINE_QUERIES:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want} for {n_searches} searches and "
                             f"{n_batches} batches")
    slo = eng.slo_stats()
    peak = torch.cuda.max_memory_allocated()
    stats = {"queries": len(rids), "wall_s": wall,
             "queries_per_s": len(rids) / wall,
             "items_per_s": n_items / wall,
             "retrieve_ms_per_query": timed.total_s / n_searches * 1e3,
             "p50_s": slo["p50_s"], "p99_s": slo["p99_s"],
             "slo_met_frac": slo["slo_met_frac"], "batches": n_batches,
             "launches": launches, "peak_bytes": peak}
    log(f"{label} (ServingEngine fused, depth {cfg.pipeline_depth}, wall "
        f"clock): {len(rids)} queries in {wall:.3f} s = "
        f"{stats['queries_per_s']:.1f} queries/s, "
        f"{stats['items_per_s']:.1f} items/s; retrieve "
        f"{stats['retrieve_ms_per_query']:.3f} ms per query; P50 "
        f"{slo['p50_s'] * 1e3:.1f} ms, P99 {slo['p99_s'] * 1e3:.1f} ms, "
        f"SLO met {slo['slo_met_frac']:.3f}; {slo['n_rejected']} rejected; "
        f"every request answered once, no item dropped; launches "
        f"{launches}; peak device memory {peak / 2 ** 30:.2f} GiB")
    log(f"{label} scheduler_stats: {json.dumps(eng.scheduler_stats())}")
    return stats


# ---------------------------------------------------------------------------
# phase 9: host vs fused engine on one SimClock workload
# ---------------------------------------------------------------------------

def phase_engine_parity(cfg: TrustIRConfig, make_searcher, evaluate, dev,
                        label: str, trust_atol: float) -> None:
    """One seeded two-tenant workload (raw queries from the corpus's
    query model, 64 to 2048 candidates each) through a host-drain and a
    fused-drain engine on SimClocks, each with a searcher from
    ``make_searcher()``: the same admissions, rejection reasons, regimes
    and tiers, trust within ``trust_atol``."""
    corpus = make_searcher().corpus
    qm = ZipfQueryModel.for_corpus(corpus, seed=SEED + 5)
    wl = MultiTenantWorkload(
        tenants=[TenantSpec("interactive", qps=40.0, priority_mix={
                     Priority.CRITICAL: 1.0, Priority.HIGH: 2.0},
                     min_results=TOP_K, max_results=TOP_K),
                 # up to 2048 candidates: bursts past Ucapacity +
                 # Uthreshold, so LOW requests meet the shed ladder
                 TenantSpec("batch", qps=60.0, priority_mix={
                     Priority.NORMAL: 2.0, Priority.LOW: 1.0},
                     min_results=TOP_K, max_results=32 * TOP_K)],
        n_queries=96, seed=SEED, query_model=qm)
    reports = {}
    for mode in ("host", "fused"):
        eng = ServingEngine(cfg, evaluate, drain_mode=mode, device=dev,
                            sim_clock=SimClock(cfg.u_capacity
                                               / cfg.deadline_s))
        reports[mode] = run_scheduled_workload(eng, make_searcher(), wl)
    host, fused = reports["host"].responses, reports["fused"].responses
    if [r.request_id for r in host] != [r.request_id for r in fused]:
        raise AssertionError("host and fused engines answered differently")
    worst = 0.0
    for a, b in zip(host, fused):
        if (a.admitted, a.reason, int(a.shed.regime)) != \
                (b.admitted, b.reason, int(b.shed.regime)) \
                or not np.array_equal(a.tier, b.tier):
            raise AssertionError(f"request {a.request_id}: host and fused "
                                 f"engines disagree")
        worst = max(worst, float(np.abs(a.trust - b.trust).max()))
    if worst > trust_atol:
        raise AssertionError(f"{label}: host vs fused trust differs by "
                             f"{worst}")
    sh, sf = reports["host"].summary(), reports["fused"].summary()
    log(f"{label} parity (SimClock, {len(host)} queries): host and fused "
        f"tiers, admissions, reasons and regimes identical, max |trust "
        f"diff| {worst:.3e} <= {trust_atol}; {sf['n_admitted']} admitted, "
        f"rejections {sf['rejected_by_reason']}, heavy+ share "
        f"{sf['frac_heavy+']:.3f} (host {sh['frac_heavy+']:.3f})")


# ---------------------------------------------------------------------------
# phase 9b: the serving fleet (the launcher's default scheduled mode)
# ---------------------------------------------------------------------------

def live_shards(coord) -> list:
    return [s for s in coord.searcher.shards if s.n_docs]


def shard_views(coord, query: str, label: str) -> list:
    """Each live shard's float64 BM25 scores for ``query``: the input
    ``topk_select`` gets there, kept for the kernel check at that N."""
    return [(label, s.n_docs, s.score(query)) for s in live_shards(coord)]


def fleet_serve(coord, queries, rids) -> tuple:
    """Enqueue ``queries`` with one drain round every 48; returns the
    ``topk_select`` launches they need (one per live shard a search)
    and the seconds their retrieves took."""
    n_topk, retrieve_s = 0, 0.0
    for i, (q, prio, tenant) in enumerate(queries):
        n_topk += len(live_shards(coord))
        rids.append(coord.enqueue_query(q, priority=prio, tenant=tenant))
        retrieve_s += coord.searcher.last_retrieve_s
        if (i + 1) % QUERIES_PER_DRAIN == 0:
            coord.drain(max_rounds=1)
    return n_topk, retrieve_s


def phase_fleet(fcfg: TrustIRConfig, retrieval, shard, evaluate, mk,
                dev) -> tuple:
    """``trust_ir.config()`` as a fleet of FLEET_REPLICAS replicas on
    the card: one ``ClusterCoordinator`` over the main path's
    ``CorpusRetrieval`` (each replica indexes the stripes the ring gives
    it), the full-width evaluator shared by every replica, gossip and
    hedging on. The main path's 384 queries, 24 more, a graceful leave
    of the most loaded replica and a join, 72 more; launch counts set to
    0 just before and read just after. Returns the launch counts, the
    fleet searcher and the shards' scores for one query before and after
    the handoff."""
    t0 = time.monotonic()
    coord = ClusterCoordinator(
        fcfg, evaluate, evaluate_batch=evaluate,
        cluster_cfg=ClusterConfig(gossip=True,
                                  hedge_after_s=fcfg.deadline_s),
        retrieval=retrieval, device=dev)
    build_s = time.monotonic() - t0
    t1 = time.monotonic()
    for s in live_shards(coord):
        s._ensure_dense()
    torch.cuda.synchronize()
    dense_s = time.monotonic() - t1
    if coord.max_batch_items != ENGINE_BATCH:
        raise AssertionError(f"fleet micro-batch {coord.max_batch_items}, "
                             f"expected {ENGINE_BATCH}")
    owners = list(coord.partition_owners().values())
    stripes = {r.replica_id: owners.count(r.replica_id)
               for r in coord.replicas}
    log(f"fleet: {coord.n_replicas} replicas of {fcfg.name} (drain "
        f"{fcfg.drain_mode}, depth {fcfg.pipeline_depth}); the ring gives "
        f"{stripes} of {fcfg.index_partitions} stripes; shards of "
        f"{[s.n_docs for s in live_shards(coord)]} docs (topk_select N "
        f"{[s._d_pad for s in live_shards(coord)]}); stripes indexed on the "
        f"host in {build_s:.1f} s (the main path's one-shard build is "
        f"printed under retrieval), dense forms on the card in "
        f"{dense_s:.1f} s")
    # one warm query per replica: the fused step's shapes on each card
    # stream, as the serve launcher warms them
    for rep in coord.replicas:
        rep.engine.enqueue_query("term00001 term00002")
        rep.engine.drain()
    coord.drain()
    coord.completed.clear()
    base = coord.scheduler_stats()
    q0 = engine_queries(retrieval.corpus, SEED + 3, 1)[0][0]
    views = shard_views(coord, q0, "before handoff")

    queries = engine_queries(retrieval.corpus, SEED + 3, ENGINE_QUERIES)
    extra = engine_queries(retrieval.corpus, SEED + 6, FLEET_EXTRA_QUERIES)
    rids: list = []
    torch.cuda.synchronize()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    runs = [fleet_serve(coord, queries, rids)]
    # half a drain's worth of queries queues up before the leave, so the
    # leaving replica has a backlog to hand off
    half = QUERIES_PER_DRAIN // 2
    runs.append(fleet_serve(coord, extra[:half], rids))
    t_change = time.monotonic()
    # the most loaded replica leaves, so its backlog hands off
    victim = max(coord.replicas,
                 key=lambda r: (r.queued_items, r.replica_id)).replica_id
    moved = coord.remove_replica(victim, drain=True)
    joined = coord.add_replica().replica_id
    change_s = time.monotonic() - t_change
    runs.append(fleet_serve(coord, extra[half:], rids))
    coord.drain()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: w.launches for name, w in KERNELS.items()}
    want_topk = sum(n for n, _ in runs)
    retrieve_s = sum(t for _, t in runs)

    st = coord.scheduler_stats()
    n_batches = st["n_batches"] - base["n_batches"]
    n_items = st["n_batched_items"] - base["n_batched_items"]
    want = {"topk_select": want_topk, "shed_partition": n_batches,
            "flash_attention": N_LAYERS * n_batches, "dot_interaction": 0,
            "flash_decode": 0}
    if launches != want:
        raise AssertionError(f"fleet: launches {launches}, expected {want}")
    answered = [r.request_id for r in coord.completed]
    if sorted(answered) != sorted(rids) or len(set(answered)) != len(rids):
        raise AssertionError(f"fleet: {len(rids)} requests, {len(answered)} "
                             f"answers, {len(set(answered))} distinct")
    for r in coord.completed:
        if not np.isfinite(r.trust).all() or len(r.trust) != len(r.tier):
            raise AssertionError(f"fleet request {r.request_id}: trust "
                                 f"malformed")
        if (r.tier == TIER_INVALID).any():
            raise AssertionError(f"fleet request {r.request_id} dropped an "
                                 f"item")
        if not r.admitted and not r.reason:
            raise AssertionError(f"fleet request {r.request_id} rejected "
                                 f"without a reason")
    views += shard_views(coord, q0, "after handoff")

    # the fleet searcher against the Python BM25 oracle
    for q, _, _ in engine_queries(retrieval.corpus, SEED + 7,
                                  FLEET_ORACLE_QUERIES):
        docs, scores = coord.searcher.retrieve(q, TOP_K)
        want_q = topk_py(shard.score_py(q), TOP_K)
        if docs.tolist() != [d for d, _ in want_q] \
                or scores.tolist() != [x for _, x in want_q]:
            raise AssertionError(f"fleet retrieval differs from the Python "
                                 f"oracle for {q!r}")

    # dispatch on a fleet replica never waits for the card
    sh = coord.replicas[0].engine.shedder
    keys = np.arange(900_001, 900_001 + ENGINE_BATCH, dtype=np.uint32)
    staged = sh.stage(keys, np.zeros(ENGINE_BATCH, np.int32),
                      mk(ENGINE_BATCH, fseed=900_001))
    torch.cuda.set_sync_debug_mode("error")
    try:
        pending = sh.dispatch_staged(staged)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pending.result()

    slo = coord.slo_stats()
    c = st["cluster"]
    g = st["gossip"]
    per_rep = {rid: e["n_batches"] - base["per_replica"].get(
        rid, {"n_batches": 0})["n_batches"]
        for rid, e in st["per_replica"].items()}
    order = {rid: i for i, rid in enumerate(rids)}
    slowest = sorted((r for r in coord.completed if r.admitted),
                     key=lambda r: -r.latency_s)[:6]
    slow_rows = [(order[r.request_id], r.priority.name,
                  round(r.latency_s, 3), round(r.queue_delay_s, 3))
                 for r in slowest]
    log(f"fleet (ClusterCoordinator x{FLEET_REPLICAS} fused, depth "
        f"{fcfg.pipeline_depth}, wall clock): {len(rids)} queries "
        f"({ENGINE_QUERIES + half}, then leave {victim} handing off "
        f"{moved} queued requests and join {joined} in {change_s:.3f} s, "
        f"then {FLEET_EXTRA_QUERIES - half}) in {wall:.3f} s = "
        f"{len(rids) / wall:.1f} queries/s, {n_items / wall:.1f} items/s; "
        f"retrieve {retrieve_s / len(rids) * 1e3:.3f} ms per query "
        f"({retrieve_s / wall:.3f} of the wall); P50 "
        f"{slo['p50_s'] * 1e3:.1f} ms, P99 {slo['p99_s'] * 1e3:.1f} ms, "
        f"SLO met {slo['slo_met_frac']:.3f}; slowest (enqueue index, "
        f"priority, latency s, queue delay s) {slow_rows}; "
        f"{n_batches} batches {per_rep}, "
        f"{c['n_steals']} steals, {c['n_hedges']} hedges "
        f"({c['n_twin_drops']} twins dropped), gossip {g['n_messages']} "
        f"messages ({g['n_messages'] / len(per_rep):.1f} per replica), "
        f"{g['n_applied']} deltas applied, {c['n_duplicate_evals']} "
        f"duplicate evals; {c['n_partition_moves']} stripes moved, "
        f"{c['n_warm_handoff_entries']} warm cache entries handed off; "
        f"every request answered once, no item dropped; launches "
        f"{launches} == {want}; shards now "
        f"{[s.n_docs for s in live_shards(coord)]} docs (N "
        f"{[s._d_pad for s in live_shards(coord)]})")
    log(f"fleet: {FLEET_ORACLE_QUERIES} queries through the fleet searcher "
        f"equal the Python BM25 oracle, ids and float64 scores; "
        f"dispatch_staged on replica {coord.replicas[0].replica_id}: no "
        f"host-device sync under sync debug mode 'error'")
    log(f"fleet scheduler_stats: "
        f"{json.dumps({k: v for k, v in st.items() if k != 'capacity'})}")
    return launches, coord.searcher, views


def phase_fleet_parity(fcfg: TrustIRConfig, searcher, evaluate, views,
                       dev) -> list:
    """Host drain against fused drain for the fleet: two coordinators
    of the same config on SimClocks, one seeded 96-query workload
    through ``run_cluster_workload`` (candidates from the fleet
    searcher); then ``topk_select`` against its plain version at every
    shard size the fleet built, with its times there."""
    qm = ZipfQueryModel.for_corpus(searcher.corpus, seed=SEED + 5)
    wl = MultiTenantWorkload(
        tenants=[TenantSpec(f"interactive{i}", qps=20.0, priority_mix={
                     Priority.CRITICAL: 1.0, Priority.HIGH: 2.0},
                     min_results=TOP_K, max_results=TOP_K)
                 for i in range(2)]
        + [TenantSpec(f"batch{i}", qps=30.0, priority_mix={
               Priority.NORMAL: 2.0, Priority.LOW: 1.0},
               min_results=TOP_K, max_results=32 * TOP_K)
           for i in range(2)],
        n_queries=96, seed=SEED, query_model=qm)
    reports, coords = {}, {}
    for mode in ("host", "fused"):
        coords[mode] = ClusterCoordinator(
            reduced(fcfg, drain_mode=mode), evaluate,
            evaluate_batch=evaluate,
            cluster_cfg=ClusterConfig(gossip=True,
                                      hedge_after_s=fcfg.deadline_s),
            sim_rate_items_per_s=fcfg.u_capacity / fcfg.deadline_s,
            device=dev)
        reports[mode] = run_cluster_workload(coords[mode], searcher, wl)
    host = sorted(reports["host"].responses, key=lambda r: r.request_id)
    fused = sorted(reports["fused"].responses, key=lambda r: r.request_id)
    if [r.request_id for r in host] != [r.request_id for r in fused]:
        raise AssertionError("fleet parity: host and fused fleets answered "
                             "differently")
    worst = 0.0
    for a, b in zip(host, fused):
        if (a.admitted, a.reason, int(a.shed.regime), a.shed.n_evaluated,
                a.shed.n_cached, a.shed.n_prior) != \
                (b.admitted, b.reason, int(b.shed.regime),
                 b.shed.n_evaluated, b.shed.n_cached, b.shed.n_prior) \
                or not np.array_equal(a.tier, b.tier):
            raise AssertionError(f"fleet parity: request {a.request_id}: "
                                 f"host and fused fleets disagree")
        worst = max(worst, float(np.abs(a.trust - b.trust).max()))
    if worst > TRUST_ATOL:
        raise AssertionError(f"fleet parity: trust differs by {worst}")
    sh_, sf = (reports[m].scheduler_stats for m in ("host", "fused"))
    for key in ("n_submitted", "n_admitted", "n_rejected", "n_batches",
                "rejected_by_reason"):
        if sh_[key] != sf[key]:
            raise AssertionError(f"fleet parity: {key} {sh_[key]} vs "
                                 f"{sf[key]}")
    cf = sf["cluster"]
    summary = reports["fused"].summary()
    log(f"fleet parity (SimClock, {len(host)} queries, "
        f"{FLEET_REPLICAS} replicas): host and fused tiers, admissions, "
        f"reasons, regimes and counts identical, max |trust diff| "
        f"{worst:.3e} <= {TRUST_ATOL}; {summary['n_admitted']} admitted, "
        f"rejections {summary['rejected_by_reason']}, heavy+ share "
        f"{summary['frac_heavy+']:.3f}; steals {cf['n_steals']} (host "
        f"{sh_['cluster']['n_steals']}), hedges {cf['n_hedges']} (host "
        f"{sh_['cluster']['n_hedges']})")

    flush = l2_flusher(dev)
    cases, seen = [], set()
    for label, n_docs, scores in views:
        want_v, want_i = topk_select_ref(scores, TOP_K)
        got_v, got_i = topk_select(scores, TOP_K)
        torch.cuda.synchronize()
        if not torch.equal(got_i, want_i) or not torch.equal(
                got_v.view(torch.int64), want_v.view(torch.int64)):
            raise AssertionError(f"topk_select differs from the plain "
                                 f"version on a fleet shard ({label}, "
                                 f"{n_docs} docs, N {scores.shape[0]})")
        n = int(scores.shape[0])
        if n not in seen:
            seen.add(n)
            t = topk_timing(scores, TOP_K, flush)
            cases.append({"n": n, "docs": n_docs, "ms": t["ms"],
                          "plain_ms": t["plain_ms"],
                          "library_ms": t["library_ms"],
                          "bound_ms": t["bound_ms"]})
    del flush
    log(f"topk_select on the fleet's shards: {len(views)} shards (before "
        f"and after the handoff) exactly equal to the plain version; "
        + "; ".join(f"N {c['n']}: kernel {c['ms']:.4f} ms, plain "
                    f"{c['plain_ms']:.4f}, torch.topk "
                    f"{c['library_ms']:.4f}, bound {c['bound_ms']:.6f}"
                    for c in cases))
    return cases


# ---------------------------------------------------------------------------
# phase 9c: the tail-tolerant fan-out (quorum gather, shard hedges, mirrors)
# ---------------------------------------------------------------------------

def fanout_run(fcfg: TrustIRConfig, retrieval, evaluate, dev, counted: bool):
    """One fan-out fleet on SimClocks over FANOUT_QUERIES seeded arrivals
    through ``run_churn_workload``, replica r0 slowed by a ``slow`` event
    after FANOUT_SLOW_AT queries and healed by ``recover`` after
    FANOUT_RECOVER_AT. With ``counted`` every launch count is set to 0
    just before the run and read just after. Returns the coordinator,
    its report, the mirrors ``add_mirror`` built (key, host, shard), the
    launches, the wall seconds and the summed retrieve seconds."""
    t0 = time.monotonic()
    coord = ClusterCoordinator(
        fcfg, evaluate, evaluate_batch=evaluate,
        cluster_cfg=ClusterConfig(gossip=True),
        sim_rate_items_per_s=fcfg.u_capacity / fcfg.deadline_s,
        retrieval=retrieval, fanout_model=ShardServiceModel(seed=SEED),
        device=dev)
    build_s = time.monotonic() - t0
    fan = coord.searcher
    if not isinstance(fan, FanoutSearcher):
        raise AssertionError("fan-out: the coordinator built no "
                             "FanoutSearcher")
    built = []
    add_mirror = fan.add_mirror

    def record(key, host, shard, warm=True):
        built.append((key, host, shard))
        add_mirror(key, host, shard, warm)

    fan.add_mirror = record
    qm = ZipfQueryModel.for_corpus(retrieval.corpus, seed=SEED + 9)
    wl = MultiTenantWorkload(
        tenants=[TenantSpec(f"tenant{i}", qps=FANOUT_QPS / 4,
                            priority_mix={Priority.CRITICAL: 1.0,
                                          Priority.HIGH: 2.0,
                                          Priority.NORMAL: 4.0,
                                          Priority.LOW: 1.0},
                            min_results=TOP_K, max_results=TOP_K)
                 for i in range(4)],
        n_queries=FANOUT_QUERIES, seed=SEED + 9, query_model=qm)
    arrivals = make_arrivals(wl)
    events = [ChurnEvent(t=arrivals[FANOUT_SLOW_AT][0], action="slow",
                         replica_id="r0", mult=FANOUT_STRAGGLE_MULT),
              ChurnEvent(t=arrivals[FANOUT_RECOVER_AT][0],
                         action="recover", replica_id="r0")]
    timed = TimedSearcher(fan)
    torch.cuda.synchronize()
    if counted:
        for wrapper in KERNELS.values():
            wrapper.launches = 0
    t1 = time.monotonic()
    rep = run_churn_workload(coord, timed, wl, events)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = {name: w.launches for name, w in KERNELS.items()}
    return coord, rep, built, launches, wall, timed.total_s, build_s


def phase_fanout(fcfg: TrustIRConfig, retrieval, evaluate, dev) -> dict:
    """``trust_ir.config()`` x FLEET_REPLICAS on the card with the fan-out
    on: first-3-of-4 quorum gather, shard-probe hedges after 8 ms (twice
    the service model's 4 ms base) onto mirror stripes, selective stripe
    replication; the full-width evaluator shared. Replica r0's shard is
    slowed x8 for the middle of the run (the launcher's straggler demo).
    Checks: no-drop; every late stripe cache- or prior-answered; a
    mirror of r0 built on its ring sibling, hedges won through it, and
    dropped after the recovery; the mirror's top-64 equal to r0's bit
    for bit; ``quorum_k == n`` equal to the plain fleet gather bit for
    bit; ``topk_select`` launches == live shards a query + hedge wins +
    warm probes; a replay gives the same fingerprint."""
    fcfg = reduced(fcfg, fanout_quorum_k=FANOUT_QUORUM_K,
                   fanout_hedge_after_s=FANOUT_HEDGE_AFTER_S)
    coord, rep, built, launches, wall, retrieve_s, build_s = fanout_run(
        fcfg, retrieval, evaluate, dev, counted=True)
    fan = coord.searcher
    live = live_shards(coord)
    st = rep.scheduler_stats
    fs, c = st["fanout"], st["cluster"]
    rids = [r.request_id for r in rep.responses]
    if len(rids) != FANOUT_QUERIES or len(set(rids)) != len(rids) \
            or st["n_submitted"] != FANOUT_QUERIES:
        raise AssertionError(f"fan-out: {FANOUT_QUERIES} requests, "
                             f"{len(rids)} answers, {len(set(rids))} "
                             f"distinct")
    for r in rep.responses:
        if not np.isfinite(r.trust).all() or len(r.trust) != len(r.tier):
            raise AssertionError(f"fan-out request {r.request_id}: trust "
                                 f"malformed")
        if r.admitted and (r.tier == TIER_INVALID).any():
            raise AssertionError(f"fan-out request {r.request_id} dropped "
                                 f"an item")
        if not r.admitted and not r.reason:
            raise AssertionError(f"fan-out request {r.request_id} rejected "
                                 f"without a reason")
    if not fs["n_cache_fills"] + fs["n_prior_answered"] \
            == fs["n_late_shards"] > 0:
        raise AssertionError(f"fan-out: late stripes {fs}")
    owners = coord.partition_owners()

    def ring_sibling(rid):
        first = min(p for p, owner in owners.items() if owner == rid)
        return coord.ring.sibling_for(retrieval.partition_key(first),
                                      exclude=(rid,))

    # r0's mirror, and any a transient straggler earned, on the ring
    # sibling of the slow replica's first stripe
    sibling = ring_sibling("r0")
    if ("r0", sibling) not in [b[:2] for b in built] \
            or any(h != ring_sibling(k) for k, h, _ in built):
        raise AssertionError(f"fan-out: mirrors built {[b[:2] for b in built]}"
                             f", expected r0 on its ring sibling {sibling}")
    if fs["n_shard_hedge_wins"] < 1 or c["n_stripe_replications"] \
            != len(built) or c["n_mirror_drops"] != len(built) \
            or fs["n_mirrors_live"] or any(r.mirrors for r in coord.replicas):
        raise AssertionError(f"fan-out: hedges/mirrors {fs}, cluster {c}")
    want = {"topk_select": FANOUT_QUERIES * len(live)
            + fs["n_shard_hedge_wins"] + len(built),
            "shed_partition": st["n_batches"],
            "flash_attention": N_LAYERS * st["n_batches"],
            "dot_interaction": 0, "flash_decode": 0}
    if launches != want:
        raise AssertionError(f"fan-out: launches {launches}, expected {want}"
                             f" ({len(live)} live shards x {FANOUT_QUERIES} "
                             f"queries + {fs['n_shard_hedge_wins']} hedge "
                             f"wins + {len(built)} warm probes)")

    qm = ZipfQueryModel.for_corpus(retrieval.corpus, seed=SEED + 10)
    checks = [qm.sample() for _ in range(FLEET_ORACLE_QUERIES)]
    mirror = next(m for k, _, m in built if k == "r0")
    primary = coord.by_id["r0"].shard
    for q in checks:
        d0, s0 = primary.retrieve(q, TOP_K)
        d1, s1 = mirror.retrieve(q, TOP_K)
        if d0.tolist() != d1.tolist() or s0.tobytes() != s1.tobytes():
            raise AssertionError(f"fan-out: the mirror of r0 ranks {q!r} "
                                 f"differently from r0")
    plain = CorpusSearcher(retrieval.corpus, live)
    fan.quorum.quorum_k = len(live)
    late0 = fan.n_late_shards
    for q in checks:
        d0, s0 = plain.retrieve(q, TOP_K)
        d1, s1 = fan.retrieve(q, TOP_K)
        if d0.tolist() != d1.tolist() or s0.tobytes() != s1.tobytes():
            raise AssertionError(f"fan-out: quorum_k == n differs from the "
                                 f"plain gather for {q!r}")
    if fan.n_late_shards != late0:
        raise AssertionError("fan-out: quorum_k == n left a stripe late")

    replay, replay_rep, _, _, _, _, _ = fanout_run(fcfg, retrieval,
                                                   evaluate, dev,
                                                   counted=False)
    prints = [response_fingerprint(rep.responses),
              response_fingerprint(replay_rep.responses)]
    if prints[0] != prints[1] \
            or replay_rep.scheduler_stats["fanout"] != fs:
        raise AssertionError(f"fan-out: the replay differs {prints}")
    del replay, replay_rep

    slo = coord.slo_stats()
    stats = {"queries": FANOUT_QUERIES, "wall_s": wall,
             "queries_per_s": FANOUT_QUERIES / wall,
             "retrieve_ms_per_query": retrieve_s / FANOUT_QUERIES * 1e3,
             "gather_p50_ms_simulated": fs["gather_p50_s"] * 1e3,
             "gather_p99_ms_simulated": fs["gather_p99_s"] * 1e3,
             "full_p50_ms_simulated": fs["full_p50_s"] * 1e3,
             "full_p99_ms_simulated": fs["full_p99_s"] * 1e3,
             "late_stripes": fs["n_late_shards"],
             "hedges": fs["n_shard_hedges"],
             "hedge_wins": fs["n_shard_hedge_wins"],
             "mirrors_built": fs["n_mirrors_built"],
             "mirrors_dropped": fs["n_mirrors_dropped"],
             "batches": st["n_batches"], "launches": launches,
             "fingerprint": prints[0]}
    log(f"fan-out (ClusterCoordinator x{coord.n_replicas} fused on "
        f"SimClocks, quorum {FANOUT_QUORUM_K} of {len(live)}, shard hedge "
        f"after {FANOUT_HEDGE_AFTER_S * 1e3:.0f} ms, r0 x"
        f"{FANOUT_STRAGGLE_MULT:.0f} from query {FANOUT_SLOW_AT} to "
        f"{FANOUT_RECOVER_AT}; stripes indexed on the host in {build_s:.1f}"
        f" s): {FANOUT_QUERIES} queries in {wall:.3f} s of wall clock = "
        f"{stats['queries_per_s']:.1f} queries/s; retrieve "
        f"{stats['retrieve_ms_per_query']:.3f} ms per query on the wall "
        f"clock ({retrieve_s / wall:.3f} of it); simulated service model "
        f"(not the card's time): gather p50/p99 "
        f"{stats['gather_p50_ms_simulated']:.2f}/"
        f"{stats['gather_p99_ms_simulated']:.2f} ms against the full "
        f"gather's {stats['full_p50_ms_simulated']:.2f}/"
        f"{stats['full_p99_ms_simulated']:.2f} ms; {fs['n_late_shards']} late"
        f" stripes ({fs['n_cache_fills']} cache-filled, "
        f"{fs['n_prior_answered']} prior-answered), {fs['n_shard_hedges']} "
        f"shard hedges ({fs['n_shard_hedge_wins']} won by the mirror), "
        f"mirrors built {[b[:2] for b in built]} (r0's ring sibling "
        f"{sibling}) / dropped {fs['n_mirrors_dropped']} by the end; "
        f"P50 {slo['p50_s'] * 1e3:.1f} ms, P99 {slo['p99_s'] * 1e3:.1f} ms "
        f"simulated; {st['n_batches']} batches; every request answered "
        f"once, no item dropped; launches {launches} == {want}")
    log(f"fan-out: r0's mirror equals r0 on {len(checks)} queries (top-"
        f"{TOP_K} ids and float64 score bits); quorum_k == n equals the "
        f"plain fleet gather bit for bit on {len(checks)} queries; replay "
        f"fingerprint equal {prints[0]}")
    log(f"fan-out scheduler_stats: "
        f"{json.dumps({k: v for k, v in st.items() if k != 'capacity'})}")
    return stats


def phase_chaos(dev) -> dict:
    """The chaos trace of CHAOS_ARGV through the serve launcher's own
    functions, twice on one calibrated config: the smoke-width evaluator
    measured on the card sets the simulated rate, the oracle evaluator
    answers, every replica's Trust DB lives on the card. Both replays
    must hold no-drop and give one fingerprint."""
    args = serve._parser().parse_args(CHAOS_ARGV + ["--device", "cuda"])
    _, _, rate = serve.calibrate(args.arch, dev)
    cfg = serve.serve_config(args, rate)
    prints = []
    for run in range(2):
        coord, rep = serve.trace_fleet(args, cfg, rate, dev)
        if not serve.report_trace(args, coord, rep):
            raise AssertionError(f"chaos run {run}: no-drop violated")
        if coord.replicas[0].engine.shedder.cache["keys"].device.type \
                != dev.type:
            raise AssertionError("chaos: the Trust DB is not on the card")
        prints.append(response_fingerprint(rep.responses))
    if prints[0] != prints[1]:
        raise AssertionError(f"chaos: replays differ {prints}")
    st = rep.scheduler_stats
    log(f"chaos: trace replayed twice at {rate:,.0f} items/s (the smoke "
        f"evaluator's rate on the card): fingerprints equal {prints[0]}; "
        f"{len(rep.responses)} responses, {st['n_executor_errors']} "
        f"executor errors, {st['n_quarantined']} quarantined, events "
        f"{[row[1] for row in rep.churn_log]}")
    return {"fingerprint": prints[0], "responses": len(rep.responses)}


def phase_baselines(evaluate, mk, dev) -> list:
    """Paper Fig 3.2 on the wall clock with the full-width evaluator, as
    the reference's real-evaluator variant runs it: the evaluator's rate
    on the card (after warm-up, one chunk) sets Ucapacity and Uthreshold
    at ``trust_ir.config()``'s deadlines, so "study in USA" at the
    paper's 89,141 results is a Very-Heavy overload here as it was on
    the paper's hardware; ``ProcessAll``, ``RLSEDA`` and
    ``LoadShedder``, each warmed on disjoint keys first."""
    base = trust_ir.config()
    cs = base.chunk_size
    chunk = {k: torch.as_tensor(v, device=dev)
             for k, v in mk(cs, fseed=31).items()}
    evaluate(chunk).float().cpu()
    t0 = time.perf_counter()
    reps = 8
    for _ in range(reps):
        evaluate(chunk).float().cpu()
    rate = reps * cs / (time.perf_counter() - t0)
    cfg = reduced(base, u_capacity=int(rate * base.deadline_s),
                  u_threshold=int(rate * (base.overload_deadline_s
                                          - base.deadline_s)))
    n = PAPER_RESULTS
    cut = ""
    if n / rate > PROCESS_ALL_MAX_S:
        n = int(rate * PROCESS_ALL_MAX_S)
        cut = (f" (cut from {PAPER_RESULTS}: ProcessAll would take "
               f"{PAPER_RESULTS / rate:.1f} s at this rate)")
    keys = np.arange(1, n + 1, dtype=np.uint32)
    buckets = (np.arange(n) % 64).astype(np.int32)
    feats = mk(n, fseed=PAPER_RESULTS)
    warm_n = 4 * cs
    warm = (np.arange(2_000_001, 2_000_001 + warm_n, dtype=np.uint32),
            np.zeros(warm_n, np.int32), mk(warm_n, fseed=32))
    log(f"baselines: evaluator {rate:,.1f} items/s on the card (chunks of "
        f"{cs}) -> Ucapacity {cfg.u_capacity}, Uthreshold "
        f"{cfg.u_threshold} at deadlines {cfg.deadline_s} / "
        f"{cfg.overload_deadline_s} s; query {PAPER_QUERY!r} with {n} "
        f"results{cut}")
    rows = []
    for name, cls, kw in (("ProcessAll", ProcessAll, {}),
                          ("RLSEDA", RLSEDA, {"seed": SEED}),
                          ("LoadShedder", LoadShedder, {})):
        shed = cls(cfg, evaluate, device=dev, **kw)
        shed.process(*warm)
        ucap, uthr = shed.monitor.parameters()  # what the run starts from
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = shed.process(keys, buckets, feats)
        wall = time.perf_counter() - t0
        if not np.isfinite(res.trust).all():
            raise AssertionError(f"{name}: trust not finite")
        invalid = int((res.tier == TIER_INVALID).sum())
        row = {"system": name, "n": n, "wall_s": wall,
               "response_time_s": res.response_time_s,
               "deadline_eff_s": res.deadline_eff_s,
               "regime": res.regime.name, "n_evaluated": res.n_evaluated,
               "n_cached": res.n_cached, "n_prior": res.n_prior,
               "n_dropped": invalid}
        rows.append(row)
        log(f"baselines: {name:<11} response {res.response_time_s:.3f} s "
            f"(wall {wall:.3f} s), {res.regime.name}, evaluated "
            f"{res.n_evaluated} cached {res.n_cached} prior {res.n_prior}"
            f", dropped {invalid}{cut if name == 'ProcessAll' else ''}")
        if name == "ProcessAll" and (res.n_evaluated != n or invalid):
            raise AssertionError("ProcessAll did not evaluate every item")
        if name == "RLSEDA":
            if invalid != n - min(n, ucap + uthr) or invalid == 0:
                raise AssertionError(f"RLSEDA left {invalid} items at "
                                     f"TIER_INVALID, expected "
                                     f"{n - min(n, ucap + uthr)}")
        if name == "LoadShedder":
            bound = res.deadline_eff_s + cs / rate
            if invalid or res.response_time_s > bound:
                raise AssertionError(f"LoadShedder: response "
                                     f"{res.response_time_s:.3f} s > "
                                     f"deadline_eff + one chunk "
                                     f"{bound:.3f} s, or dropped "
                                     f"{invalid}")
    log(f"baselines: LoadShedder answered every item within deadline_eff "
        f"{rows[2]['deadline_eff_s']:.3f} s + one chunk "
        f"{cs / rate:.3f} s, "
        f"{rows[0]['response_time_s'] / rows[2]['response_time_s']:.2f}x "
        f"faster than ProcessAll; RLSEDA dropped {rows[1]['n_dropped']} "
        f"items (its flaw)")
    return rows


# ---------------------------------------------------------------------------
# phase 10: the serving engine on the full-width DLRM evaluator
# ---------------------------------------------------------------------------

def dlrm_interaction_check(evaluate, mk, dev) -> float:
    """``dot_interaction`` against its plain version on the features the
    DLRM evaluator feeds it (the bottom MLP's post-ReLU output beside the
    26 looked-up rows) for one engine micro-batch: the f32 split's error
    grows with the rows' norms, which these set, not the unit-norm rows
    of the kernel phase."""
    seen = []
    kernel = dlrm_model.dot_interaction

    def record(feats):
        seen.append(feats)
        return kernel(feats)

    dlrm_model.dot_interaction = record
    try:
        f = mk(ENGINE_BATCH, fseed=700_001)
        evaluate({name: torch.as_tensor(v, device=dev)
                  for name, v in f.items()})
    finally:
        dlrm_model.dot_interaction = kernel
    (feats,) = seen
    got, want = dot_interaction(feats), dot_interaction_ref(feats)
    torch.cuda.synchronize()
    err = max_err(got, want)
    norms = feats.float().norm(dim=-1)
    if not torch.isfinite(got).all() or err > F32_ATOL:
        raise AssertionError(f"dot_interaction on the DLRM evaluator's "
                             f"features: max abs err {err} > {F32_ATOL}")
    log(f"dlrm: dot_interaction on the evaluator's own features "
        f"{tuple(feats.shape)} {feats.dtype} (row norms: bottom MLP max "
        f"{float(norms[:, 0].max()):.3f}, tables max "
        f"{float(norms[:, 1:].max()):.3f}; largest Gram entry "
        f"{float(want.abs().max()):.3f}): max abs err {err:.3e} <= "
        f"{F32_ATOL}")
    return err


def phase_dlrm(cfg: TrustIRConfig, corpus, shard, dev) -> dict:
    """dlrm-mlperf at its published widths with every table capped at
    DLRM_ROW_CAP rows, seeded weights drawn on the card; the main path's
    384 queries through ``ServingEngine`` on the 65536-document shard
    already built (a DLRM feature function in place of the tokens), then
    the host-vs-fused engine parity run with this evaluator."""
    full = get_config("dlrm-mlperf")
    capped = cap_table_rows(full, DLRM_ROW_CAP)
    cut = [(t.name, t.vocab, c.vocab) for t, c in zip(full.tables,
                                                      capped.tables)
           if t.vocab != c.vocab]
    rows = {name: sum(E.padded_rows(t.vocab) for t in c.tables)
            for name, c in (("full", full), ("capped", capped))}
    log(f"dlrm: {len(full.tables)} tables of dim {full.embed_dim}, "
        f"{rows['full']} padded rows ({rows['full'] * 512 / 1e9:.1f} GB "
        f"f32) as published; capped at {DLRM_ROW_CAP} rows (cuts "
        f"{', '.join(f'{n} {a}->{b}' for n, a, b in cut)}): "
        f"{rows['capped']} rows ({rows['capped'] * 512 / 1e9:.1f} GB)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    evaluate, mk = make_evaluator("dlrm-mlperf", smoke=False, seed=SEED,
                                  device=dev, max_table_rows=DLRM_ROW_CAP)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    log(f"dlrm: evaluator built on the card in {time.monotonic() - t0:.1f} "
        f"s, {held / 1e9:.2f} GB of weights")
    feats_err = dlrm_interaction_check(evaluate, mk, dev)

    def doc_features(docs):        # retrieved docs -> DLRM features
        return mk(len(docs), fseed=int(docs[0]) % 1_000_000
                  if len(docs) else 0)

    def make_searcher():
        return CorpusSearcher(corpus, [shard], feature_fn=doc_features)

    counted = CountedEvaluator(evaluate)

    def expect(n_searches, n_batches):
        return {"topk_select": n_searches, "shed_partition": n_batches,
                "flash_attention": 0, "dot_interaction": counted.calls,
                "flash_decode": 0}

    stats = phase_engine(cfg, make_searcher(), counted, dev, "dlrm engine",
                         expect)
    if not 0 < stats["launches"]["dot_interaction"] == counted.calls:
        raise AssertionError(f"dot_interaction launched "
                             f"{stats['launches']['dot_interaction']} times "
                             f"for {counted.calls} evaluator calls")
    phase_engine_parity(cfg, make_searcher, evaluate, dev, "dlrm engine",
                        DLRM_TRUST_ATOL)
    fused = FusedLoadShedder(cfg, evaluate, device=dev)
    batches = [(np.arange(off, off + ENGINE_BATCH, dtype=np.uint32),
                np.zeros(ENGINE_BATCH, np.int32),
                mk(ENGINE_BATCH, fseed=off)) for off in (500_001, 600_001)]
    fused.process(*batches[0])
    device_profile(f"one fused DLRM step, {ENGINE_BATCH} items",
                   lambda: fused.process(*batches[1]))
    stats["peak_bytes"] = torch.cuda.max_memory_allocated()
    stats["feats_err"] = feats_err
    log(f"dlrm: {counted.calls} evaluator calls in the measured run, each "
        f"one dot_interaction launch; peak device memory of the phase "
        f"{stats['peak_bytes'] / 2 ** 30:.2f} GiB")
    return stats


# ---------------------------------------------------------------------------
# phase 10b: the BST, MIND and two-tower evaluators on the main path
# ---------------------------------------------------------------------------

def phase_recsys(cfg: TrustIRConfig, corpus, shard, dev) -> dict:
    """Each recommender of RECSYS_ARCHS at its published widths (rows
    capped where the entry says so), seeded weights drawn on the card:
    one micro-batch's scores in [0, 5]; the main path's 384 queries
    through ``ServingEngine`` on the 65536-document shard with the
    arch's features; the host-vs-fused engine parity run; one fused
    step under the profiler. Each evaluator's tables are freed before
    the next is built."""
    out = {}
    for arch, cap in RECSYS_ARCHS:
        full = get_config(arch)
        used = cap_table_rows(full, cap) if cap else full
        rows = {name: sum(E.padded_rows(t.vocab) for t in c.tables)
                for name, c in (("full", full), ("used", used))}
        width = 4 * full.embed_dim
        cut = [(t.name, t.vocab, u.vocab) for t, u in zip(full.tables,
                                                          used.tables)
               if t.vocab != u.vocab]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        evaluate, mk = make_evaluator(arch, smoke=False, seed=SEED,
                                      device=dev, max_table_rows=cap)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        log(f"{arch}: {len(full.tables)} tables of dim {full.embed_dim}, "
            f"{rows['full']} padded rows ({rows['full'] * width / 1e9:.2f} "
            f"GB f32) as published"
            + (f"; capped at {cap} rows (cuts "
               f"{', '.join(f'{n} {a}->{b}' for n, a, b in cut)}): "
               f"{rows['used']} rows ({rows['used'] * width / 1e9:.2f} GB)"
               if cut else "; nothing cut")
            + f"; evaluator built on the card in {time.monotonic() - t0:.1f}"
            f" s, {held / 1e9:.2f} GB of weights")
        feats = {k: torch.as_tensor(v, device=dev)
                 for k, v in mk(ENGINE_BATCH, fseed=800_001).items()}
        scores = evaluate(feats)
        if scores.shape != (ENGINE_BATCH,) or not torch.isfinite(
                scores).all() or scores.min() < 0 or scores.max() > 5:
            raise AssertionError(f"{arch}: scores {tuple(scores.shape)} "
                                 f"outside [0, 5] or not finite")

        def doc_features(docs, mk=mk):    # retrieved docs -> features
            return mk(len(docs), fseed=int(docs[0]) % 1_000_000
                      if len(docs) else 0)

        def make_searcher(doc_features=doc_features):
            return CorpusSearcher(corpus, [shard], feature_fn=doc_features)

        def expect(n_searches, n_batches):
            return {"topk_select": n_searches, "shed_partition": n_batches,
                    "flash_attention": 0, "dot_interaction": 0,
                    "flash_decode": 0}

        stats = phase_engine(cfg, make_searcher(), evaluate, dev,
                             f"{arch} engine", expect)
        phase_engine_parity(cfg, make_searcher, evaluate, dev,
                            f"{arch} engine", RECSYS_TRUST_ATOL)
        fused = FusedLoadShedder(cfg, evaluate, device=dev)
        batches = [(np.arange(off, off + ENGINE_BATCH, dtype=np.uint32),
                    np.zeros(ENGINE_BATCH, np.int32),
                    mk(ENGINE_BATCH, fseed=off))
                   for off in (500_001, 600_001)]
        fused.process(*batches[0])
        stats["profile"] = device_profile(
            f"one fused {arch} step, {ENGINE_BATCH} items",
            lambda: fused.process(*batches[1]))
        stats["peak_bytes"] = torch.cuda.max_memory_allocated()
        stats["weights_bytes"] = held
        stats["scores_range"] = (float(scores.min()), float(scores.max()))
        log(f"{arch}: scores of one micro-batch in "
            f"[{stats['scores_range'][0]:.4f}, {stats['scores_range'][1]:.4f}]"
            f" within [0, 5]; peak device memory of the phase "
            f"{stats['peak_bytes'] / 2 ** 30:.2f} GiB")
        out[arch] = stats
        del evaluate, mk, fused, feats, scores, batches, doc_features
        del make_searcher
        gc.collect()
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: KV-cache decode on the full-width smollm-135m
# ---------------------------------------------------------------------------

def phase_decode(dev) -> dict:
    """128 seeded prompts of 1..1984 tokens, one ``prefill`` each at B 1,
    admitted into a 128-slot ``KVCachePool`` of 2048 positions; 64
    ``decode_step``s over the whole pool; every slot retired. Decode
    logits of a few slots at a few steps are held against the full
    forward over the same tokens."""
    cfg = get_config("smollm-135m")
    params = T.cast_params(
        T.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                      device=dev), L.dtype_of(cfg.dtype))
    r = np.random.default_rng(SEED + 8)
    prompt_lens = r.integers(1, MAX_PROMPT + 1, size=DECODE_SLOTS)
    prompt_lens[:2] = (1, MAX_PROMPT)              # both ends
    prompts = [r.integers(0, cfg.vocab_size, size=n) for n in prompt_lens]
    feed = r.integers(0, cfg.vocab_size, size=(DECODE_STEPS, DECODE_SLOTS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = KVCachePool(cfg, n_slots=DECODE_SLOTS, max_len=DECODE_MAX_LEN,
                       device=dev)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (pool.cache["k"], pool.cache["v"]))
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    t0 = time.monotonic()
    scores = []
    for i, p in enumerate(prompts):
        score, kv = T.prefill(params, cfg, torch.as_tensor(
            p, dtype=torch.int32, device=dev)[None])
        if pool.admit(i, kv, prompt_len=len(p)) != i:
            raise AssertionError(f"prompt {i} did not get slot {i}")
        scores.append(score)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    prefill_launches = {n: w.launches for n, w in KERNELS.items()}
    scores = torch.cat(scores)
    if prefill_launches["flash_attention"] != cfg.n_layers * DECODE_SLOTS \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"prefill: launches {prefill_launches}, "
                             f"finite scores {bool(torch.isfinite(scores).all())}")

    check_slots = (0, 1, DECODE_SLOTS * 3 // 5)  # shortest, longest, one
    check_steps = (0, DECODE_STEPS // 2, DECODE_STEPS - 1)
    kept = {}
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    t1 = time.monotonic()
    for t in range(DECODE_STEPS):
        tok = torch.as_tensor(feed[t], dtype=torch.int32, device=dev)
        logits, pool.cache = T.decode_step(params, cfg, tok, pool.cache)
        if t in check_steps:
            kept[t] = logits[list(check_slots)].float().clone()
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t1
    launches = {n: w.launches for n, w in KERNELS.items()}
    want = {n: 0 for n in KERNELS}
    want["flash_decode"] = cfg.n_layers * DECODE_STEPS
    if launches != want:
        raise AssertionError(f"decode: launches {launches}, expected {want}")
    lengths = pool.cache["lengths"].cpu().numpy()
    if not np.array_equal(lengths, prompt_lens + DECODE_STEPS):
        raise AssertionError("decode: cache lengths do not count the steps")
    peak = torch.cuda.max_memory_allocated()
    extra = torch.as_tensor(feed[0], dtype=torch.int32, device=dev)

    def one_step():
        _, pool.cache = T.decode_step(params, cfg, extra, pool.cache)

    device_profile(f"one decode_step, {DECODE_SLOTS} slots", one_step)
    for slot in range(DECODE_SLOTS):
        pool.retire(slot)
    if pool.active_mask().any() or pool.cache["lengths"].any() \
            or len(pool.alloc.free) != DECODE_SLOTS:
        raise AssertionError("decode: retire left a slot claimed")

    worst, worst_rel = 0.0, 0.0
    for slot in check_slots:
        for t in check_steps:
            toks = np.concatenate([prompts[slot], feed[:t + 1, slot]])
            with torch.no_grad():
                full = T.forward(params, cfg, torch.as_tensor(
                    toks, dtype=torch.int32, device=dev)[None])[0, -1]
            diff = (kept[t][check_slots.index(slot)] - full.float()).abs()
            worst = max(worst, float(diff.max()))
            worst_rel = max(worst_rel, float(diff.norm()
                                             / full.float().norm()))
    if worst > DECODE_LOGIT_ATOL:
        raise AssertionError(f"decode logits differ from the forward by "
                             f"{worst} > {DECODE_LOGIT_ATOL}")
    n_tokens = DECODE_SLOTS * DECODE_STEPS
    row = cfg.n_kv_heads * cfg.d_head * 2 * 2        # k and v, bf16
    kv_read = [cfg.n_layers * int((prompt_lens + t + 1).sum()) * row
               for t in range(DECODE_STEPS)]
    stats = {"prefill_s": prefill_s, "decode_s": decode_s,
             "tokens_per_s": n_tokens / decode_s,
             "step_ms": decode_s / DECODE_STEPS * 1e3,
             "kv_bytes_per_step": float(np.mean(kv_read)),
             "launches": launches, "peak_bytes": peak,
             "logit_err": worst}
    log(f"decode: {DECODE_SLOTS} prompts of 1..{MAX_PROMPT} tokens (mean "
        f"{prompt_lens.mean():.0f}) prefilled in {prefill_s:.2f} s "
        f"({prefill_launches['flash_attention']} flash_attention launches) "
        f"into a KVCachePool of {DECODE_SLOTS} x {DECODE_MAX_LEN} "
        f"({kv_bytes / 1e9:.2f} GB bf16)")
    log(f"decode: {DECODE_STEPS} decode_steps over {DECODE_SLOTS} slots in "
        f"{decode_s:.3f} s = {stats['tokens_per_s']:.1f} tokens/s, "
        f"{stats['step_ms']:.2f} ms per step; KV bytes read per step "
        f"{stats['kv_bytes_per_step'] / 1e9:.3f} GB (mean), "
        f"{stats['kv_bytes_per_step'] / (stats['step_ms'] / 1e3) / 1e12:.3f} "
        f"TB/s of step time; launches {launches}; logits vs the full "
        f"forward at slots {check_slots}, steps {check_steps}: max abs err "
        f"{worst:.3e} <= {DECODE_LOGIT_ATOL} (relative {worst_rel:.3e}); "
        f"every slot retired; peak device memory {peak / 2 ** 30:.2f} GiB")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.monotonic()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    card = card_line()
    log(f"card: {card}")
    phase_build()

    cfg = TrustIRConfig()
    kernels = [phase_shed_partition(cfg, dev), phase_flash_attention(dev),
               phase_topk_select(dev), phase_dot_interaction(dev),
               phase_flash_decode(dev)]
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    evaluate, mk = make_evaluator(cfg.evaluator_arch, smoke=False,
                                  seed=SEED, device=dev)
    torch.cuda.synchronize()
    log(f"evaluator: full-width {cfg.evaluator_arch} "
        f"({N_LAYERS} layers, bf16) built in {time.monotonic() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    phase_regime_parity(cfg, evaluate, mk, dev)
    phase_serving(cfg, evaluate, mk, dev)
    peak = torch.cuda.max_memory_allocated()
    log(f"peak device memory (parity + serving): {peak / 2 ** 30:.2f} GiB")
    phase_profile(cfg, evaluate, mk, dev)

    ecfg = TrustIRConfig(corpus_docs=CORPUS_DOCS, drain_mode="fused",
                         pipeline_depth=2)
    corpus, retrieval, shard = build_retrieval(ecfg, mk, dev)
    phase_retrieval(corpus, retrieval, shard, dev)

    def smollm_expect(n_searches, n_batches):
        return {"topk_select": n_searches, "shed_partition": n_batches,
                "flash_attention": N_LAYERS * n_batches,
                "dot_interaction": 0, "flash_decode": 0}

    engine = phase_engine(ecfg, retrieval.searcher([shard]), evaluate, dev,
                          "engine", smollm_expect)
    phase_engine_parity(ecfg, lambda: retrieval.searcher([shard]), evaluate,
                        dev, "engine", TRUST_ATOL)
    fcfg = reduced(trust_ir.config(), n_replicas=FLEET_REPLICAS,
                   drain_mode="fused", pipeline_depth=2,
                   corpus_docs=CORPUS_DOCS)
    seconds = {}
    t0 = time.monotonic()
    fleet_launches, fleet_searcher, views = phase_fleet(
        fcfg, retrieval, shard, evaluate, mk, dev)
    seconds["fleet"] = time.monotonic() - t0
    t0 = time.monotonic()
    fleet_topk = phase_fleet_parity(fcfg, fleet_searcher, evaluate, views,
                                    dev)
    del fleet_searcher, views
    seconds["fleet_parity"] = time.monotonic() - t0
    t0 = time.monotonic()
    fanout = phase_fanout(fcfg, retrieval, evaluate, dev)
    seconds["fanout"] = time.monotonic() - t0
    gc.collect()
    t0 = time.monotonic()
    phase_chaos(dev)
    seconds["chaos"] = time.monotonic() - t0
    t0 = time.monotonic()
    phase_baselines(evaluate, mk, dev)
    seconds["baselines"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fleet phases: seconds {json.dumps(seconds)}")
    dlrm = phase_dlrm(ecfg, corpus, shard, dev)
    gc.collect()                       # the DLRM tables go with the phase
    torch.cuda.empty_cache()
    log(f"dlrm tables freed: {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB still allocated")
    t0 = time.monotonic()
    recsys = phase_recsys(ecfg, corpus, shard, dev)
    log(f"recsys phases: {time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still allocated")
    decode = phase_decode(dev)

    by_path = {"engine": engine["launches"], "fleet": fleet_launches,
               "fanout": fanout["launches"], "dlrm": dlrm["launches"],
               **{arch: st["launches"] for arch, st in recsys.items()},
               "decode": decode["launches"]}
    path_launches = {name: sum(run[name] for run in by_path.values())
                     for name in KERNELS}
    for kern in kernels:
        if kern["name"] == "dot_interaction":
            kern["dlrm_feats_max_abs_err"] = dlrm["feats_err"]
            kern["max_abs_err"] = max(kern["max_abs_err"], dlrm["feats_err"])
        if kern["name"] == "topk_select":
            kern["fleet_shard_cases"] = fleet_topk
        kern["launches"] = path_launches[kern["name"]]
        kern["launches_by_path"] = {path: run[kern["name"]]
                                    for path, run in by_path.items()
                                    if run[kern["name"]]}
        if kern["launches"] < 1:
            raise AssertionError(f"{kern['name']} was not launched on its "
                                 f"path")
    log(f"chip_smoke: all phases passed in "
        f"{time.monotonic() - t_start:.1f} s")

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
