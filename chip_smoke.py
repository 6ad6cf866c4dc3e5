#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's eight CUDA kernels from ``src/repro_torch/csrc`` in
parallel and holds each against its plain PyTorch version at the shapes
its path gives it:

* ``shed_partition``: Trust-DB probe, regime tiers, eval budget and
  compacted eval rank of one micro-batch (exact);
* ``flash_attention``: causal GQA attention of the transformer
  evaluator, of ``prefill`` and of training (with its row log-sum-exp);
  in bf16 three instances: the warp-specialised ``wgmma`` one that
  ``long_instance`` gives the long sequences (the prefills, training, a
  D 128 training row with qwen2.5's heads, and gemma2's D 256 with its
  window and softcap), the persistent TMA-fed one that
  ``short_instance`` gives the evaluators' S 31 at D 64 and 128
  (smollm's at the fused drain's and the engine's batches, the Qwen
  models' at theirs, both of its instances held to the plain version
  and repeating their bits), and the ``mma.sync`` one (D 16, gemma2's S
  31, D 64 or 128 with a window or a softcap); each row printed with its
  instance, the ``mma.sync`` instance timed beside the other two through
  the overrides, and the new kernels' registers and spills from this
  run's build (none may spill or serialise its wgmma);
* ``topk_select``: the candidate set of one query (exact);
* ``dot_interaction``: the DLRM evaluator's pairwise feature dots;
* ``flash_decode``: one-token attention against the KV cache, and its
  instance that also writes each head's log-sum-exp (the
  sequence-sharded decode's), with two halves of a cache merged by their
  lse against one call over the whole;
* ``score_head``: the evaluators' fused scoring head (each position's
  target log-probability, no logit in device memory) at smollm-135m's,
  qwen3-moe-30b-a3b's and qwen2.5-14b's steps (tied (V, d) and untied
  (d, V) weights), held to the plain chunked path within 1e-4 plus one
  bf16 ulp of the target's logit, repeating its bits, timed beside its
  bound, the plain path and ``cross_entropy`` on materialised bf16
  logits (``launch/time_score_head.py``); every path's launch check
  counts it, and at the end each path's calls by instance
  (``check_head_instances``): the kernel for smollm's and the Qwens'
  heads, the chunked path for gemma2's softcapped head;
* ``flash_attention_bwd`` and ``dot_interaction_bwd``: the gradients of
  the two forward kernels on the training path; each must also repeat
  its bits from one call to the next (the attention backward adds dq
  in a fixed order), and at the training shape the attention
  backward's three launches are timed apart by the profiler beside the
  main kernel's registers and spills from this run's build (none may
  spill at D 128 or D 256); the backward is also held to its plain
  version at a cut training length (B 1, S 1024) and timed at B 2, S
  4096 at D 128 (qwen2.5's heads) and D 256 (gemma2's, softcap 50)
  beside SDPA's backward, with the forward that writes the lse.

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
* the mesh-sharded path on the card's (1, 1) mesh (``phase_sharded``, a
  world of one): ``make_sharded_evaluator`` over the full-width
  smollm-135m weights through ``ServingEngine(feature_sharding=...)``
  at depth 2 and 4096-item batches, held to the replicated engine bit
  for bit on SimClocks and timed beside it on the wall clock; the
  sharded DLRM over the replicated evaluator's own capped tables; and
  ``serve --sharded --sync --drain-mode fused`` as a user runs it;
* the same engine on the full-width ``bst``, ``mind`` and
  ``two-tower-retrieval`` evaluators in turn (``shed_partition`` and
  ``topk_select`` only; the two-tower tables capped at 20M rows), each
  with its host-vs-fused parity run and one profiled fused step;
* KV-cache decode on the smollm-135m weights: 128 prompts prefilled
  (``flash_attention``) into a 128-slot ``KVCachePool``, 64
  ``decode_step``s over the pool (``flash_decode``), decode logits
  checked against the full forward;
* the other evaluator families at their published widths and depths:
  ``gemma2-2b`` on the main path's engine (``flash_attention`` at D 256
  with its softcap) with its host-vs-fused parity run, then in KV decode
  over a 16 x 8192 ``KVCachePool`` (``flash_decode`` at D 256, the
  4096-key window of its local layers biting); ``qwen2.5-14b``,
  ``qwen3-moe-30b-a3b``, ``moonshot-v1-16b-a3b`` and ``gcn-cora`` each
  on the fused drain, a few micro-batches, each model's weights freed
  before the next is built; the two MoE models then also through
  ``make_sharded_evaluator`` on the card's (1, 1) mesh over the same
  weights (experts placed by the EP rule, ``moe_apply_ep``), on the same
  SimClock batches as the replicated evaluator;
* training (``phase_train``): smollm-135m at its published width and
  depth (float32 master weights, bf16 compute, remat), 6 steps of 4 x 8
  x 4096 tokens with an ``AsyncCheckpointer`` save at step 3 and a
  restart from it that must reproduce the straight run bit for bit, its
  step-0 loss and one microbatch's gradient held against the float32
  run with the plain attention; then dlrm-mlperf at its published widths
  (tables capped at 4M rows) on batches of 65536, its gradient held
  against ``dot_interaction_ref``; then gemma2-2b at its published width
  and depth (the attention backward at D 256 with its softcap), 3 steps
  of 2 x 4096 tokens, its step-0 loss and gradient held as smollm's and
  its first step run twice from the same state, bit for bit; then
  (``phase_train_smoke``) every
  arch at smoke width through the training launcher's code path on the
  card and on the CPU, loss histories compared, and the launcher itself
  on the card;
* the mesh cells (``phase_mesh_cells``): smollm-135m's ``train_4k`` cell
  (``launch.steps.build_cell``) on the card's (1, 1) mesh, its batch cut
  to 8 x 4096, three steps equal to the replicated train step's bit for
  bit, its state saved and resumed by ``ElasticMeshManager``; then the
  dry-run (``python -m repro_torch.launch.dryrun``) of smollm's and
  qwen3-moe's ``train_4k`` cells on the single-pod mesh of a fake
  process group, as subprocesses, their records printed.

Beside the kernel checks, the two attention kernels are held against
their plain versions and timed at the new evaluators' heads (D 256 with
softcap and window, qwen2.5's 40/8 x 128, the D 12 smoke head padded to
16), gemma2's D 256 ``wgmma`` instances at its training microbatch and
its longest prefill beside the ``mma.sync`` instance they replaced (no D
256 ``wgmma`` instance may spill or serialise its wgmma), and each new
evaluator at smoke width on the card against the CPU.

Every path's ``flash_attention`` launches are also counted by instance:
the S 31 of smollm's and the Qwen models' evaluators must all have run
on the short instance, gemma2's on ``mma.sync``.

Any failure raises and exits non-zero. Without a CUDA device it exits
non-zero before printing any result.

Output: one line per phase; then the card's name and power limit (as
``nvidia-smi`` reports them), the ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``.

Numerics: TF32 is switched off for matmuls and cuDNN, so float32
products are full float32 and the tolerances below hold.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.chaos import response_fingerprint  # noqa: E402
from repro_torch.cluster import (ClusterConfig,  # noqa: E402
                                 ClusterCoordinator)
from repro_torch.configs import (TransformerConfig,  # noqa: E402
                                 TrustIRConfig, get_config)
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
from repro_torch.launch import ab_attention as AB  # noqa: E402
from repro_torch.launch import time_score_head as TSH  # noqa: E402
from repro_torch.launch.ab_attention import decode_case  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.kernels import dot_interaction as DI  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import flash_decode as FD  # noqa: E402
from repro_torch.kernels import shed_partition as SP  # noqa: E402
from repro_torch.kernels import score_head as SH  # noqa: E402
from repro_torch.kernels import topk_select as TS  # noqa: E402
from repro_torch.kernels.dot_interaction import (  # noqa: E402
    dot_interaction, dot_interaction_bwd, dot_interaction_bwd_ref,
    dot_interaction_ref, group_size, triu_pairs)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.flash_decode import (  # noqa: E402
    flash_decode, flash_decode_ref, piece_length)
from repro_torch.kernels.shed_partition import (  # noqa: E402
    shed_partition, shed_partition_ref)
from repro_torch.kernels.topk_select import (  # noqa: E402
    NEG_INF, TILE, launch_floor, staged_capacity, topk_select,
    topk_select_ref)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.recsys import dlrm as dlrm_model  # noqa: E402
from repro_torch.models.recsys import embedding as E  # noqa: E402
from repro_torch.retrieval import (CorpusRetrieval, CorpusSearcher,  # noqa: E402
                                   IndexShard, SyntheticCorpus,
                                   ZipfQueryModel, topk_py)
from repro_torch.scheduling import Priority, SchedulerConfig  # noqa: E402
from repro_torch.scheduling.executor import DrainExecutor  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.evaluators import make_evaluator  # noqa: E402
from repro_torch.serving.kv_cache import KVCachePool  # noqa: E402
from repro_torch.configs.registry import arch_ids  # noqa: E402
from repro_torch.training import checkpoint as CK  # noqa: E402
from repro_torch.training import data as TD  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as TL  # noqa: E402
from repro_torch.training.tree import (leaves,  # noqa: E402
                                       leaves_with_paths, tree_map)
from repro_torch.serving.simulator import (  # noqa: E402
    ChurnEvent, MultiTenantWorkload, TenantSpec, make_arrivals,
    run_churn_workload, run_cluster_workload, run_scheduled_workload)

# Every kernel wrapper of the port, each with its launch count.
KERNELS = {"shed_partition": shed_partition,
           "flash_attention": flash_attention,
           "topk_select": topk_select,
           "dot_interaction": dot_interaction,
           "flash_decode": flash_decode,
           "flash_attention_bwd": flash_attention_bwd,
           "dot_interaction_bwd": dot_interaction_bwd,
           "score_head": SH.score_head}
# What the serving paths launch of the training kernels.
NO_BACKWARD = {"flash_attention_bwd": 0, "dot_interaction_bwd": 0}

# NVIDIA H100 SXM data-sheet peaks (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores. The bound of a kernel
# is the larger of bytes / HBM rate and operations / peak rate for its
# type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def bound(cost, dtype) -> dict:
    """A kernel's bound from its module's ``cost`` (operations, bytes) at
    this run's inputs: the larger of the bytes over the HBM rate and the
    operations over the peak rate of ``dtype``."""
    flops, n_bytes = cost
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "flops": flops}

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
DLRM_SHARDED_ATOL = 1e-6         # sharded vs replicated DLRM scores
SHARDED_REQUEST = BATCH // 2     # items a request in the sharded phase
SHARDED_REQUESTS = 16            # 8 micro-batches of BATCH items
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
# The evaluator families beside smollm, at their published widths and
# depths. gemma2-2b (arXiv:2408.00118) on the main path, and in KV decode
# over its published context of 8192 positions: 16 slots, prompts of up to
# 8000 tokens, so that about half the rows pass the local layers' 4096-key
# window, then 16 steps.
GEMMA = "gemma2-2b"
# The path each transformer evaluator's scoring head takes
# (``kernels.score_head.instance``): the kernel, but for gemma2's
# softcapped head.
HEAD_INSTANCE = {"smollm-135m": "fused", "qwen3-moe-30b-a3b": "fused",
                 "moonshot-v1-16b-a3b": "fused", "qwen2.5-14b": "fused",
                 GEMMA: "chunked"}
GEMMA_DECODE_SLOTS = 16
GEMMA_MAX_LEN = 8192
GEMMA_MAX_PROMPT = 8000
GEMMA_DECODE_STEPS = 16
# gemma2's decode vs its full forward, both bf16: the logits have std ~1
# (rms-normed states times a 0.02-std table of width 2304), twice
# smollm's, over 26 layers; a wrong position or cache row moves them by
# O(1).
GEMMA_DECODE_LOGIT_ATOL = 0.25
# The other evaluators on the fused drain. The fused drain runs its
# evaluator on max_evals rows of each 4096-item micro-batch; each cap is
# the largest multiple of 1024 rows whose evaluator call fits on the card
# beside the weights, as src/repro_torch/launch/evaluator_memory.py
# measured it (peaks 50.2 GiB for qwen2.5 at 4096 rows; 70.3 GiB for
# qwen3-moe at 2048, out of memory at 3072; 72.9 GiB for moonshot at
# 3072, out of memory at 4096). A cut of traffic: the rest of a batch
# takes the prior tier, no item is dropped. 0 = the whole micro-batch.
BIG_EVALUATORS = (("qwen2.5-14b", 0), ("qwen3-moe-30b-a3b", 2048),
                  ("moonshot-v1-16b-a3b", 3072), ("gcn-cora", 0))
# Full-width checks of the big evaluators. The first MoE layer, bf16, at
# MOE_CHECK_ROWS tokens against a plain float32 MoE on the same weights
# and inputs, once on the drain's documents and once on Zipf-skewed
# tokens that overflow the hottest experts: bf16 rounds each of the
# GLU's three products and the combine, a relative error of 4.5e-3 to
# 4.8e-3 on an H100, while a wrong slot, expert or weight moves a token's
# output by O(1). A dense model's trust of DENSE_CHECK_ITEMS documents
# against the same weights in float32: 48 bf16 layers of qwen2.5-14b
# move it by 2.6e-2 on an H100; the limit is the main path's fused-vs-host
# trust tolerance.
SHARDED_MOE_BATCHES = 4         # SimClock batches, replicated vs sharded
MOE_CHECK_ROWS = 64
MOE_ZIPF_A = 1.2
MOE_REL_TOL = 2e-2
DENSE_CHECK_ITEMS = 32
DENSE_TRUST_ATOL = TRUST_ATOL
# q times BITE_Q gives logits of spread ~40 at scale D^-0.5: past a softcap
# of 50, which randn inputs (logits ~1) never reach.
BITE_Q = 40.0
BIG_BATCHES = 4
NEW_ARCHS = ("gemma2-2b", "qwen2.5-14b", "qwen3-moe-30b-a3b",
             "moonshot-v1-16b-a3b", "gcn-cora")
# Paper Fig 3.2: the query "study in USA" returns 89,141 results in the
# paper's Nutch setup (benchmarks/bench_response_time.py).
PAPER_QUERY, PAPER_RESULTS = "study in USA", 89_141
PROCESS_ALL_MAX_S = 30.0         # ProcessAll's time cap: the count is cut


# phase_train: smollm-135m at its published width and depth, float32
# master weights, bf16 compute, remat; microbatches of 8 x 4096 tokens
# (train_4k's sequence length), 4 accumulated: 131,072 tokens a step (the
# global batch cut from 256 to 32 sequences by one card and the time
# limit). AdamW with the launcher's defaults; a checkpoint at step 3, a
# restart from it, and the checks below.
TRAIN_ARCH = "smollm-135m"
TRAIN_MICRO, TRAIN_SEQ, TRAIN_ACCUM = 8, 4096, 4
TRAIN_STEPS, TRAIN_CKPT_STEP = 6, 3
TRAIN_LR = 3e-3                  # the training launcher's default --lr
TRAIN_LOSS_ATOL = 2e-2           # step 0's bf16 loss vs the f32 plain run
TRAIN_GRAD_COS = 0.99            # per leaf, bf16 kernels vs f32 plain
TRAIN_NORM_RTOL = 0.05           # global gradient norms


class LMRun(NamedTuple):
    """One LM training run of ``phase_train_lm``, at the arch's published
    width and depth, sequences of TRAIN_SEQ."""
    arch: str
    micro: int                   # sequences a microbatch
    accum: int                   # microbatches a step
    steps: int
    ckpt_step: int               # > 0: a save there and a restart from it;
                                 # 0: one step repeated from the same state
    lr: float = TRAIN_LR


TRAIN_LM = LMRun(TRAIN_ARCH, TRAIN_MICRO, TRAIN_ACCUM, TRAIN_STEPS,
                 TRAIN_CKPT_STEP)
# gemma2-2b (26 layers, d_model 2304, 8/4 heads of 256, softcap 50): ~2.6 B
# parameters, 16 bytes each of float32 masters, AdamW's m and v and the
# float32 gradient sum, ~42 GB; one sequence of 4096 a microbatch, 2
# accumulated: 8,192 tokens a step (the global batch cut from 256
# sequences to 2), 3 steps. No checkpoint (42 GB to disk): the repeat
# check runs the first step again from the same state instead. AdamW's
# peak lr 1e-4: at the launcher's 3e-3 (and at 1e-3) the third step's
# loss ended above the first's on an H100; at 1e-4 the gradient norm
# falls 9.59 -> 7.85 over the three steps and the loss with it (each
# step's loss is on its own batch, and the second batch's is 0.03 higher
# at the start, whatever the lr).
GEMMA_TRAIN = LMRun(GEMMA, 1, 2, 3, 0, lr=1e-4)
# dlrm-mlperf training at its published widths, every table capped at 4M
# rows (12.3 GB; 49.3 GB with gradients and both AdamW moments), the
# reference's train_batch of 65536.
DLRM_TRAIN_ROW_CAP = 4_000_000
DLRM_TRAIN_BATCH = 65536
DLRM_TRAIN_STEPS = 4
DLRM_GRAD_COS = 0.99999           # per leaf, f32 kernels vs f32 plain
# phase_train_smoke: every arch at smoke width, card vs CPU.
SMOKE_TRAIN_STEPS = 3
MESH_CELL_BATCH = 8              # sequences a step (the cell's 256, cut)
MESH_CELL_STEPS = 3
SMOKE_TRAIN_ATOL = 1e-4
# the D 128 / D 256 backward rows at a training length are held to the
# plain version at this cut sequence (B 1), and timed at TRAIN_SEQ
LONG_CHECK_SEQ = 1024
BWD_REL_TOL = {torch.bfloat16: BF16_ATOL, torch.float32: F32_ATOL}


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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bytes."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def ptxas_report(name: str, entry: str) -> dict:
    """Registers and spill bytes of each instance of kernel ``entry`` in
    library ``name``, and whether ptxas serialised its wgmma
    (``wgmma_serialized``), from this run's ``-Xptxas -v`` output, keyed by
    the mangled name's head dimension (``_lse`` for the instance that
    writes the lse); empty if the library was not built in this run."""
    out, cur = {}, None
    for line in BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if entry in m.group(1) else None
            continue
        m = re.search(entry + r"ILi(\d+)E(?:Lb([01])E)?", line)
        if m and "serialized" in line:
            key = f"D{m.group(1)}" + ("_lse" if m.group(2) == "1" else "")
            out.setdefault(key, {})["wgmma_serialized"] = True
            continue
        if cur is None:
            continue
        arg = re.search(r"ILi(\d+)E(?:Lb([01])E)?", cur)
        key = (f"D{arg.group(1)}" + ("_lse" if arg.group(2) == "1" else "")
               if arg else cur)
        row = out.setdefault(key, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# phase 1-2: card and build
# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


BUILD_LOGS: dict = {}               # nvcc -Xptxas -v output of this run
# the kernels a redesign replaced, built beside the port's to be timed in
# the same run: ab_attention's variant name -> its loaded library
REPLACED: dict = {}
REPLACED_VARIANTS = ("d16_mma_sync",)   # the bf16 D 16 backward's


def phase_build() -> None:
    t0 = time.monotonic()
    started = {name: AB.start_variant_build(name, backward=True)
               for name in REPLACED_VARIANTS}
    logs = _build.build(list(KERNELS))
    for name, proc in started.items():
        REPLACED[name] = AB.finish_variant_build(name, proc)[0]
    BUILD_LOGS.update(logs)
    log(f"build: {len(logs)} kernels compiled in "
        f"{time.monotonic() - t0:.1f} s, and the replaced kernels "
        f"{list(REPLACED)} beside them")
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
    way_reads = int(ways_read[probe].sum())
    hits = int(hit[probe].sum())
    return SP.cost(keys.shape[0], way_reads, hits)[1]


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
    lse_ms = {}
    for name, (qq, kk, vv) in (("evaluator", (q, k, v)),
                               ("prefill", (q5, k5, v5))):
        lse = torch.empty((qq.shape[0], Hq, qq.shape[1]),
                          dtype=torch.float32, device=dev)
        lse_ms[name] = timed_ms(lambda: FA._forward(
            qq, kk, vv, True, 0, 0.0, D ** -0.5, lse), 20, flush)
    log(f"flash_attention @evaluator shape ({instance_of(q, k)}): kernel "
        f"{timing['ms']:.4f} ms, "
        f"plain {timing['plain_ms']:.4f} ms, sdpa {timing['library_ms']:.4f} "
        f"ms (sdpa max abs err {max_err(timing['library_out'], want):.3e}), "
        f"bound {timing['bound_ms']:.4f} ms ({timing['bound_by']}: "
        f"{timing['bytes']} B, {timing['flops']} FLOP)")
    short_rows = [short_row(q, k, v, flush, "smollm evaluator", timing),
                  short_row(q3, k3, v3, flush, "smollm at the engine's "
                            "batch", attention_timing(q3, k3, v3, flush,
                                                      plain_iters=0))]
    del q3, k3, v3
    short_ptx = short_ptxas()
    log(f"flash_attention short instance (ptxas, this run's build): "
        f"{json.dumps(short_ptx)}")
    prefill = attention_timing(q5, k5, v5, flush, plain_iters=0)
    prefill_old = mma_sync_ms(q5, k5, v5, flush)
    prefill_check = forward_check(q5, k5, v5, "prefill")
    log(f"flash_attention @prefill shape (B=1, S={MAX_PROMPT}, "
        f"{instance_of(q5, k5)}; rule: S >= {FA.LONG_FROM}): kernel "
        f"{prefill['ms']:.4f} ms (P split), with the lse (bf16 P once) "
        f"{lse_ms['prefill']:.4f} ms; the mma.sync instance "
        f"{prefill_old['ms']:.4f} / {prefill_old['lse_ms']:.4f} ms; sdpa "
        f"{prefill['library_ms']:.4f} ms (sdpa "
        f"max abs err {max_err(prefill['library_out'], want5):.3e}), bound "
        f"{prefill['bound_ms']:.6f} ms ({prefill['bound_by']}: "
        f"{prefill['bytes']} B, {prefill['flops']} FLOP); "
        f"{json.dumps(prefill_check)}")
    log(f"flash_attention with the lse output (training's forward): "
        f"{lse_ms['evaluator']:.4f} ms at the evaluator shape (without: "
        f"{timing['ms']:.4f}), {lse_ms['prefill']:.4f} ms at the prefill "
        f"shape (without: {prefill['ms']:.4f})")
    wgmma_ptxas = ptxas_report("flash_attention", "fa_fwd_wgmma_kernel")
    log(f"flash_attention wgmma instance (ptxas, this run's build): "
        f"{json.dumps(wgmma_ptxas)}")

    # training: smollm-135m's microbatch, (8, 4096, 9/3, 64) bf16, causal
    tq, tk, tv, tdo = attention_inputs(TRAIN_MICRO, TRAIN_SEQ, Hq, Hkv, D,
                                       torch.bfloat16, gen, dev) + (
        torch.randn((TRAIN_MICRO, TRAIN_SEQ, Hq, D), generator=gen,
                    device=dev).to(torch.bfloat16),)
    brow = attention_bwd_check(tq, tk, tv, tdo, dict(causal=True, window=0,
                                                     softcap=0.0),
                               "training microbatch")
    train_check = forward_check(tq, tk, tv, "training microbatch")
    train_old = mma_sync_ms(tq, tk, tv, flush)
    bt = attention_bwd_timing(tq, tk, tv, tdo, flush, plain_iters=1)
    shares = attention_bwd_shares(tq, tk, tv, tdo)
    work = FA.workspace_bytes(TRAIN_MICRO, TRAIN_SEQ, Hq, D, torch.bfloat16)
    log(f"flash_attention_bwd at the training shape: two calls equal bit for"
        f" bit; launch shares of one profiled call {json.dumps(shares)}; "
        f"workspace {work} B (dq_acc "
        f"{TRAIN_MICRO * Hq * TRAIN_SEQ * D * 4} B)")
    log(f"flash_attention_bwd {brow['shape']}: dq/dk/dv within "
        f"{brow['dq_rel_err']:.3e}/{brow['dk_rel_err']:.3e}/"
        f"{brow['dv_rel_err']:.3e} of the plain output's max (<= "
        f"{BF16_ATOL}), the lse instance's o {brow['o_rel_err']:.3e}, lse "
        f"max abs err {brow['lse_max_abs_err']:.3e}; "
        f"kernel {bt['ms']:.4f} ms, plain {bt['plain_ms']:.4f} ms, sdpa "
        f"backward {bt['library_ms']:.4f} ms, bound {bt['bound_ms']:.4f} ms "
        f"({bt['bound_by']}: {bt['bytes']} B, {bt['flops']} FLOP); the "
        f"forward at this shape {bt['fwd_ms']:.4f} ms, with the lse "
        f"{bt['fwd_lse_ms']:.4f} ms, sdpa {bt['fwd_library_ms']:.4f} ms, "
        f"bound {bt['fwd_bound_ms']:.4f} ms")
    log(f"flash_attention at the training shape ({instance_of(tq, tk)}): "
        f"with the lse (bf16 P once) {bt['fwd_lse_ms']:.4f} ms, serving (P "
        f"split) {bt['fwd_ms']:.4f} ms; the mma.sync instance "
        f"{train_old['lse_ms']:.4f} / {train_old['ms']:.4f} ms; sdpa "
        f"{bt['fwd_library_ms']:.4f} ms; bound {bt['fwd_bound_ms']:.4f} ms; "
        f"{json.dumps(train_check)}")
    del tq, tk, tv, tdo

    # D 128 and D 256 at a training length: qwen2.5-14b's heads (40/8)
    # and gemma2-2b's (8/4, softcap 50). Each backward is held to the plain
    # version at a cut batch (B 1, S LONG_CHECK_SEQ) with two calls equal
    # bit for bit, then timed at B 2, S TRAIN_SEQ beside SDPA's backward
    # (without the softcap, which SDPA lacks) and the bound; so is the
    # forward with the lse, which gemma2's training runs at D 256.
    long_rows = {}
    for D, hq, hkv, cap in ((128, 40, 8, 0.0), (256, 8, 4, 50.0)):
        kw = dict(causal=True, window=0, softcap=cap)
        cut = attention_inputs(1, LONG_CHECK_SEQ, hq, hkv, D, torch.bfloat16,
                               gen, dev) + (
            torch.randn((1, LONG_CHECK_SEQ, hq, D), generator=gen,
                        device=dev).to(torch.bfloat16),)
        row = {"check": attention_bwd_check(*cut, kw, f"D {D} training "
                                            f"row, cut")}
        del cut
        full = attention_inputs(2, TRAIN_SEQ, hq, hkv, D, torch.bfloat16,
                                gen, dev) + (
            torch.randn((2, TRAIN_SEQ, hq, D), generator=gen,
                        device=dev).to(torch.bfloat16),)
        if D == 128:
            row["fwd_check"] = forward_check(*full[:3], "D 128 training row")
            row["fwd_mma_sync"] = mma_sync_ms(*full[:3], flush)
        row["timing"] = attention_bwd_timing(*full, flush, plain_iters=0,
                                             softcap=cap)
        row["instance"] = instance_of(full[0], full[1], softcap=cap)
        long_rows[D] = row
        del full
    ptxas = ptxas_report("flash_attention_bwd", "fa_bwd_main_kernel")
    spills = {k: r.get("spill_stores") for k, r in ptxas.items()}
    if any(spills.get(k) != 0 for k in ("D16", "D128", "D256")):
        raise AssertionError(f"flash_attention_bwd: the D 16 / D 128 / D 256 "
                             f"main kernel spills (this run's ptxas: "
                             f"{ptxas})")
    log(f"flash_attention_bwd main kernel (ptxas, this run's build): "
        f"{json.dumps(ptxas)}; D 16, D 128 and D 256 spill no byte")
    b128, b256 = long_rows[128]["timing"], long_rows[256]["timing"]
    d128_check, d128_old = long_rows[128]["fwd_check"], \
        long_rows[128]["fwd_mma_sync"]
    log(f"flash_attention D 128 (B=2, S={TRAIN_SEQ}, 40/8, causal, "
        f"{long_rows[128]['instance']}): with the lse "
        f"{b128['fwd_lse_ms']:.4f} ms, serving {b128['fwd_ms']:.4f} ms; the "
        f"mma.sync instance {d128_old['lse_ms']:.4f} / "
        f"{d128_old['ms']:.4f} ms; sdpa {b128['fwd_library_ms']:.4f} ms; "
        f"bound {b128['fwd_bound_ms']:.4f} ms; {json.dumps(d128_check)}")
    log(f"flash_attention D 256 with the lse (B=2, S={TRAIN_SEQ}, 8/4, "
        f"causal, softcap 50, {long_rows[256]['instance']}; gemma2's "
        f"training forward): {b256['fwd_lse_ms']:.4f} ms, sdpa (no softcap) "
        f"{b256['fwd_library_ms']:.4f} ms, bound "
        f"{b256['fwd_bound_ms']:.4f} ms")
    for D, bt_, label in ((128, b128, "40/8"), (256, b256,
                                                "8/4, softcap 50")):
        ck = long_rows[D]["check"]
        log(f"flash_attention_bwd D {D} (B=2, S={TRAIN_SEQ}, {label}, "
            f"causal): kernel {bt_['ms']:.4f} ms, sdpa backward"
            f"{' (no softcap)' if D == 256 else ''} "
            f"{bt_['library_ms']:.4f} ms, bound {bt_['bound_ms']:.4f} ms "
            f"({bt_['bound_by']}: {bt_['bytes']} B, {bt_['flops']} FLOP); at "
            f"{ck['shape']}: dq/dk/dv within {ck['dq_rel_err']:.3e}/"
            f"{ck['dk_rel_err']:.3e}/{ck['dv_rel_err']:.3e} of the plain "
            f"output's max (<= {BF16_ATOL}), two calls equal bit for bit")
    # D 16 in bf16 at smollm's training microbatch, (8, 4096, 9/3, 16):
    # no path trains it (the smoke archs train in float32). The warpgroup
    # instance is held to the plain version at the cut batch, with
    # rows handed an lse of -inf and two calls equal bit for bit, then
    # timed at the full shape beside the mma.sync kernels it replaced
    # (ab_attention's d16_mma_sync, built in this run), SDPA's backward
    # and the exps' floor; one profiled call shows its three launches.
    cut = attention_inputs(1, LONG_CHECK_SEQ, Hq, Hkv, 16, torch.bfloat16,
                           gen, dev) + (
        torch.randn((1, LONG_CHECK_SEQ, Hq, 16), generator=gen,
                    device=dev).to(torch.bfloat16),)
    d16_check = attention_bwd_check(*cut, dict(causal=True, window=0,
                                               softcap=0.0),
                                    "D 16 training row, cut", dead_rows=64)
    del cut
    full = attention_inputs(TRAIN_MICRO, TRAIN_SEQ, Hq, Hkv, 16,
                            torch.bfloat16, gen, dev) + (
        torch.randn((TRAIN_MICRO, TRAIN_SEQ, Hq, 16), generator=gen,
                    device=dev).to(torch.bfloat16),)
    b16 = attention_bwd_timing(*full, flush, plain_iters=0)
    b16["mma_sync_ms"] = replaced_bwd_ms("d16_mma_sync", *full, flush)
    d16_shares = attention_bwd_shares(*full)
    if d16_shares and "fa_bwd_main_kernel" not in d16_shares:
        raise AssertionError(f"flash_attention_bwd D 16 bf16: no warpgroup "
                             f"kernel in the profile {d16_shares}")
    del full
    # each causal score's exp once, 16 a clock an SM at the card's clock
    scores = TRAIN_MICRO * Hq * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    exp_floor = scores / (16 * torch.cuda.get_device_properties(
        0).multi_processor_count * sm_clock_hz()) * 1e3
    d16_ptxas = ptxas.get("D16", {})
    log(f"flash_attention_bwd D 16 bf16 (B={TRAIN_MICRO}, S={TRAIN_SEQ}, "
        f"{Hq}/{Hkv}, causal; on no path; the warpgroup instance): kernel "
        f"{b16['ms']:.4f} ms, the mma.sync kernels it replaced "
        f"{b16['mma_sync_ms']:.4f} ms, sdpa backward "
        f"{b16['library_ms']:.4f} ms, bound {b16['bound_ms']:.4f} ms "
        f"({b16['bound_by']}: {b16['bytes']} B, {b16['flops']} FLOP), share "
        f"{b16['bound_ms'] / b16['ms']:.3f}; the exps' floor "
        f"{exp_floor:.4f} ms ({scores} scores); launch shares "
        f"{json.dumps(d16_shares)}; main kernel ptxas "
        f"{json.dumps(d16_ptxas)}; at {d16_check['shape']}: dq/dk/dv "
        f"within {d16_check['dq_rel_err']:.3e}/"
        f"{d16_check['dk_rel_err']:.3e}/{d16_check['dv_rel_err']:.3e} of "
        f"the plain output's max, {d16_check['rows_without_key']} rows "
        f"without a key, two calls equal bit for bit")
    log(f"flash_attention D 16 bf16 at the same shape ("
        f"{FA.instance(TRAIN_SEQ, Hq // Hkv, 16, torch.bfloat16)}): serving "
        f"{b16['fwd_ms']:.4f} ms, with the lse {b16['fwd_lse_ms']:.4f} ms, "
        f"sdpa {b16['fwd_library_ms']:.4f} ms, bound "
        f"{b16['fwd_bound_ms']:.4f} ms")
    del flush
    fwd = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:97",
           "max_abs_err": err, "ms": timing["ms"],
           "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
           "bound_by": timing["bound_by"],
           "library_ms": timing["library_ms"],
           "prefill_ms": prefill["ms"],
           "prefill_library_ms": prefill["library_ms"],
           "prefill_bound_ms": prefill["bound_ms"],
           "lse_ms": lse_ms["evaluator"], "prefill_lse_ms": lse_ms["prefill"],
           "train_ms": bt["fwd_ms"], "train_lse_ms": bt["fwd_lse_ms"],
           "train_library_ms": bt["fwd_library_ms"],
           "train_bound_ms": bt["fwd_bound_ms"],
           "long_from": FA.LONG_FROM,
           "instances": {"evaluator": instance_of(q, k),
                         "prefill": instance_of(q5, k5),
                         "train": "wgmma" if FA.long_instance(
                             TRAIN_SEQ, D, torch.bfloat16) else "mma.sync",
                         "d256_train": long_rows[256]["instance"],
                         "d256_prefill": "wgmma" if FA.long_instance(
                             GEMMA_MAX_PROMPT, 256, torch.bfloat16,
                             window=4096, softcap=50.0) else "mma.sync"},
           "prefill_lse_mma_sync_ms": prefill_old["lse_ms"],
           "prefill_mma_sync_ms": prefill_old["ms"],
           "train_mma_sync_ms": train_old["ms"],
           "train_lse_mma_sync_ms": train_old["lse_ms"],
           "d128_ms": b128["fwd_ms"], "d128_lse_ms": b128["fwd_lse_ms"],
           "d128_library_ms": b128["fwd_library_ms"],
           "d128_bound_ms": b128["fwd_bound_ms"],
           "d128_mma_sync_ms": d128_old["ms"],
           "d128_lse_mma_sync_ms": d128_old["lse_ms"],
           "d256_lse_ms": b256["fwd_lse_ms"],
           "d256_library_ms": b256["fwd_library_ms"],
           "d256_bound_ms": b256["fwd_bound_ms"],
           "checks": {"prefill": prefill_check, "train": train_check,
                      "d128": d128_check},
           "wgmma_ptxas": wgmma_ptxas,
           "short_to": FA.SHORT_TO, "short": short_rows,
           "short_ptxas": short_ptx}
    bwd = {"name": "flash_attention_bwd", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
           "replaces": "src/repro/kernels/flash_attention.py:97 (its "
                       "gradient: jax.grad of the jnp attention)",
           "max_abs_err": brow["max_abs_err"], "rel_err": brow["rel_err"],
           "ms": bt["ms"], "plain_ms": bt["plain_ms"],
           "bound_ms": bt["bound_ms"], "bound_by": bt["bound_by"],
           "library_ms": bt["library_ms"],
           "shape": brow["shape"], "repeat_bits": brow["repeat_bits"],
           "launch_shares": shares, "main_kernel_ptxas": ptxas,
           "workspace_bytes": work,
           "d128_ms": b128["ms"], "d128_library_ms": b128["library_ms"],
           "d128_bound_ms": b128["bound_ms"],
           "d256_ms": b256["ms"], "d256_library_ms": b256["library_ms"],
           "d256_bound_ms": b256["bound_ms"],
           "d16_ms": b16["ms"], "d16_library_ms": b16["library_ms"],
           "d16_bound_ms": b16["bound_ms"], "d16_bound_by": b16["bound_by"],
           "d16_mma_sync_ms": b16["mma_sync_ms"],
           "d16_exp_floor_ms": exp_floor, "d16_launch_shares": d16_shares,
           "d16_fwd_ms": b16["fwd_ms"], "d16_fwd_lse_ms": b16["fwd_lse_ms"],
           "d16_fwd_library_ms": b16["fwd_library_ms"],
           "d16_fwd_bound_ms": b16["fwd_bound_ms"],
           "long_checks": {**{f"d{D}": r["check"] for D, r in
                              long_rows.items()}, "d16": d16_check}}
    return fwd, bwd


def instance_of(q, k, window: int = 0, softcap: float = 0.0) -> str:
    """The forward instance the rules (``FA.instance``) send a causal call
    on ``q``, ``k`` to: ``wgmma``, ``short``, ``mma.sync`` or ``f32``."""
    return FA.instance(q.shape[1], q.shape[2] // k.shape[2],
                       max(q.shape[-1], FA.MIN_HEAD_DIM), q.dtype,
                       window=window, softcap=softcap)


def forward_check(q, k, v, label: str, window: int = 0,
                  softcap: float = 0.0, scale=None,
                  lse_rel: bool = False) -> dict:
    """Both bf16 forward instances' o at one causal shape (serving: P
    split in two; with the lse: bf16 P once) against
    ``flash_attention_ref``, in chunks of batch rows whose float32 scores
    stay within 1 GiB, within BF16_ATOL;
    the lse against ``flash_attention_lse_ref`` within 1e-3; and a second
    call of each equal to the first bit for bit (a training restart
    repeats its bits). With ``lse_rel`` the lse instance's o is held as
    the backward checks hold it, within BWD_REL_TOL of the plain output's
    max abs (P rounded to bf16 once; its output rounds to bf16 at values
    up to ~8, where one step is 3.1e-2)."""
    B, S, Hq, D = q.shape
    kw = dict(causal=True, window=window, softcap=softcap,
              sm_scale=D ** -0.5 if scale is None else scale)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lse2 = torch.empty_like(lse)
    serving, with_lse = FA._forward(q, k, v, **kw), FA._forward(q, k, v,
                                                               lse=lse, **kw)
    same = (same_bits(serving, FA._forward(q, k, v, **kw))
            and same_bits(with_lse, FA._forward(q, k, v, lse=lse2, **kw))
            and same_bits(lse, lse2))
    errs = {"serving": 0.0, "lse_instance": 0.0}
    n = max(1, (1 << 28) // (Hq * S * S))   # batch rows a plain call
    top = 0.0                                # the plain output's max abs
    for b in range(0, B, n):
        want = flash_attention_ref(q[b:b + n], k[b:b + n], v[b:b + n], **kw)
        errs["serving"] = max(errs["serving"], max_err(serving[b:b + n], want))
        errs["lse_instance"] = max(errs["lse_instance"],
                                   max_err(with_lse[b:b + n], want))
        top = max(top, float(want.float().abs().max()))
        del want
    lse_err = max_err(lse, flash_attention_lse_ref(q, k, **kw))
    lse_tol = BWD_REL_TOL[q.dtype] * top if lse_rel else BF16_ATOL
    if not (same and errs["serving"] <= BF16_ATOL
            and errs["lse_instance"] <= lse_tol and lse_err <= 1e-3
            and torch.isfinite(serving.float()).all()):
        raise AssertionError(f"flash_attention {label}: max abs err {errs}, "
                             f"lse {lse_err}, repeat bits {same}")
    return {"instance": instance_of(q, k, window, softcap), "max_abs_err": errs,
            "lse_instance_tol": lse_tol, "lse_max_abs_err": lse_err,
            "repeat_bits": same}


def mma_sync_ms(q, k, v, flush, window: int = 0, softcap: float = 0.0,
                scale=None) -> dict:
    """The mma.sync instance's time at a shape the rules send to the wgmma
    or the short instance (``long_from=NEVER_LONG``,
    ``short_to=NEVER_SHORT``), with and without the lse: the earlier
    design beside the new one in the same run."""
    B, S, Hq, D = q.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    scale = D ** -0.5 if scale is None else scale

    def call(out_lse):
        return FA._forward(q, k, v, True, window, softcap, scale, out_lse,
                           long_from=FA.NEVER_LONG,
                           short_to=FA.NEVER_SHORT)
    return {"ms": timed_ms(lambda: call(None), 10, flush),
            "lse_ms": timed_ms(lambda: call(lse), 10, flush)}


def short_row(q, k, v, flush, label: str, t: dict) -> dict:
    """The short instance at one of the evaluators' S 31 shapes (``t``:
    its ``attention_timing``, whose kernel is the short instance): both
    of its instances held to the plain version (``forward_check``), the
    one that writes the lse timed (its o within BWD_REL_TOL of the plain
    output's max abs, the serving one's within BF16_ATOL), and the
    ``mma.sync`` instance it
    replaced timed beside it in the same run (``mma_sync_ms``)."""
    B, S, Hq, D = q.shape
    if instance_of(q, k) != "short":
        raise AssertionError(f"flash_attention {label}: the rules send "
                             f"it to {instance_of(q, k)}, not the short "
                             f"instance")
    check = forward_check(q, k, v, label, lse_rel=True)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    lse_ms = timed_ms(lambda: FA._forward(q, k, v, True, 0, 0.0, D ** -0.5,
                                          lse), 20, flush)
    old = mma_sync_ms(q, k, v, flush)
    row = {"shape": f"{label}: B={B} S={S} {Hq}/{k.shape[2]} heads D={D} "
                    f"bf16 causal", "instance": "short",
           "ms": t["ms"], "lse_ms": lse_ms, "mma_sync_ms": old["ms"],
           "mma_sync_lse_ms": old["lse_ms"],
           "faster": t["ms"] <= old["ms"] and lse_ms <= old["lse_ms"],
           "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "bound_share": t["bound_ms"] / t["ms"],
           "check": check}
    log(f"flash_attention {row['shape']} (short): serving (P split) "
        f"{t['ms']:.4f} ms, with the lse (bf16 P once) {lse_ms:.4f} ms; the "
        f"mma.sync instance {old['ms']:.4f} / {old['lse_ms']:.4f} ms; sdpa "
        f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP), "
        f"{row['bound_share']:.2f} of it; {json.dumps(check)}")
    return row


def short_ptxas() -> dict:
    """This run's ptxas report of the short instance's four kernels (D 64
    and 128, serving and lse); fails if one spills or serialises its
    wgmma."""
    ptxas = ptxas_report("flash_attention", "fa_fwd_short_kernel")
    if sorted(ptxas) != ["D128", "D128_lse", "D64", "D64_lse"] or any(
            row.get("spill_stores") != 0 or row.get("wgmma_serialized")
            for row in ptxas.values()):
        raise AssertionError(f"flash_attention: a short instance spills or "
                             f"serialises its wgmma (this run's ptxas: "
                             f"{ptxas})")
    return ptxas


def attention_timing(q, k, v, flush, plain_iters: int, window: int = 0,
                     softcap: float = 0.0, scale=None) -> dict:
    """Causal attention at one shape: the kernel, SDPA (GQA; with the
    window as a boolean mask where it is shorter than S, and no softcap,
    which SDPA lacks) and, with ``plain_iters``, the plain version, each
    with L2 flushed between launches; the bound from the bytes of q, k,
    v, o and the FLOPs of the (query, key) pairs the causal window
    leaves."""
    B, S, Hq, D = q.shape
    kw = dict(causal=True, window=window, softcap=softcap, sm_scale=scale)
    mask = None
    if 0 < window < S:
        pos = torch.arange(S, device=q.device)
        mask = ((pos[None, :] <= pos[:, None])
                & (pos[None, :] > pos[:, None] - window))

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=mask is None, scale=scale,
            enable_gqa=True)

    b = bound(FA.cost(B, S, Hq, k.shape[2], D, q.element_size(),
                      window=window), q.dtype)
    return {
        "ms": timed_ms(lambda: flash_attention(q, k, v, **kw), 20, flush),
        "plain_ms": (timed_ms(lambda: flash_attention_ref(q, k, v, **kw),
                              plain_iters, flush) if plain_iters else None),
        "library_ms": timed_ms(library, 20, flush),
        "library_out": library().transpose(1, 2), **b}


def rel_err(got, want) -> tuple:
    """(max abs error, that over the plain output's max abs)."""
    err = max_err(got, want)
    return err, err / max(float(want.float().abs().max()), 1e-30)


def attention_bwd_check(q, k, v, do, kw: dict, label: str,
                        dead_rows: int = 0) -> dict:
    """The forward kernel's instance that writes the lse: its o against
    ``flash_attention_ref`` (one batch row at a time) within BWD_REL_TOL
    of the plain output's max abs, its lse against the plain
    log-sum-exp; then the backward kernel against
    ``flash_attention_bwd_ref`` on the kernel's o and lse, each of dq, dk,
    dv within BWD_REL_TOL of its plain output's max abs, and a second call
    equal to the first bit for bit (the ordered dQ adds). ``dead_rows``
    rows are handed an lse of -inf (what the forward writes for a row that
    saw no key): their dq must be zero."""
    B, S, Hq, D = q.shape
    kw = dict(kw, sm_scale=kw.get("sm_scale") or D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    o = FA._forward(q, k, v, lse=lse, **kw)
    o_want = torch.cat([flash_attention_ref(q[b:b + 1], k[b:b + 1],
                                            v[b:b + 1], **kw)
                        for b in range(B)])
    o_err, o_rel = rel_err(o, o_want)
    del o_want
    if o.dtype != q.dtype or not torch.isfinite(o.float()).all() \
            or o_rel > BWD_REL_TOL[q.dtype]:
        raise AssertionError(f"flash_attention (lse instance) {label} o: max"
                             f" abs err {o_err} = {o_rel} of the plain "
                             f"output's max > {BWD_REL_TOL[q.dtype]}")
    lse_err = max_err(lse, flash_attention_lse_ref(q, k, **kw))
    if dead_rows:
        gen = torch.Generator(device=q.device).manual_seed(SEED + 23)
        rows = torch.randperm(B * Hq * S, generator=gen,
                              device=q.device)[:dead_rows]
        lse.view(-1)[rows] = float("-inf")
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd {label}: two calls gave "
                             f"different bits")
    del again
    tol = BWD_REL_TOL[q.dtype]
    row = {"shape": f"{label}: B={B} S={S} {Hq}/{k.shape[2]} heads D={D} "
                    f"{q.dtype} window={kw['window']} "
                    f"softcap={kw['softcap']}",
           "o_rel_err": o_rel, "lse_max_abs_err": lse_err,
           "max_abs_err": 0.0, "rel_err": 0.0, "repeat_bits": True}
    lse_tol = 1e-3 if q.dtype == torch.bfloat16 else F32_ATOL
    if lse_err > lse_tol:
        raise AssertionError(f"flash_attention lse {label}: max abs err "
                             f"{lse_err} > {lse_tol}")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, rel = rel_err(g, w)
        if g.dtype != q.dtype or not torch.isfinite(g.float()).all() \
                or rel > tol:
            raise AssertionError(f"flash_attention_bwd {label} {name}: max "
                                 f"abs err {err} = {rel} of the plain "
                                 f"output's max > {tol}")
        row[f"{name}_rel_err"] = rel
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["rel_err"] = max(row["rel_err"], rel)
    if dead_rows:
        dead = (lse == float("-inf")).permute(0, 2, 1)      # (B, S, Hq)
        zero = float(got[0][dead].float().abs().max())
        if zero != 0.0:
            raise AssertionError(f"flash_attention_bwd {label}: a row with "
                                 f"lse -inf got dq {zero}")
        row["rows_without_key"] = int(dead.sum())
    return row


def attention_bwd_timing(q, k, v, do, flush, plain_iters: int,
                         window: int = 0, softcap: float = 0.0) -> dict:
    """The causal backward at one shape: the kernel (given the forward's
    o and lse), the plain version, and the library's time for the same
    function, the backward of ``scaled_dot_product_attention(...,
    is_causal=True, enable_gqa=True)`` (timing only; no softcap), each with
    L2 flushed; the bound from the bytes of q, k, v, o, do, lse in and dq,
    dk, dv out and the FLOPs of five products over the visible pairs."""
    B, S, Hq, D = q.shape
    kw = dict(causal=True, window=window, softcap=softcap, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    o = FA._forward(q, k, v, lse=lse, **kw)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)

    shape = (B, S, Hq, k.shape[2], D, q.element_size())
    t = {"ms": timed_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw), 10, flush),
         "plain_ms": (timed_ms(lambda: flash_attention_bwd_ref(
             q, k, v, o, lse, do, **kw), plain_iters, flush)
             if plain_iters else None),
         "library_ms": timed_ms(library, 10, flush),
         **bound(FA.cost(*shape, window=window, backward=True), q.dtype),
         "fwd_ms": timed_ms(lambda: flash_attention(q, k, v, **kw), 10,
                            flush),
         "fwd_lse_ms": timed_ms(lambda: FA._forward(q, k, v, lse=lse, **kw),
                                10, flush)}
    with torch.no_grad():
        t["fwd_library_ms"] = timed_ms(
            lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True), 10, flush)
    t["fwd_bound_ms"] = bound(FA.cost(*shape, window=window),
                              q.dtype)["bound_ms"]
    del out, qt, kt, vt
    return t


def replaced_bwd_ms(name: str, q, k, v, do, flush) -> float:
    """The time of the backward kernels a redesign replaced
    (``REPLACED[name]``, the ``ab_attention`` variant built in this run)
    at one causal shape, given the port's o and lse, L2 flushed."""
    B, S, Hq, D = q.shape
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    o = FA._forward(q, k, v, lse=lse, causal=True, window=0, softcap=0.0,
                    sm_scale=D ** -0.5)
    return timed_ms(AB.bwd_call(REPLACED[name], q, k, v, o, lse, do), 10,
                    flush)


def sm_clock_hz() -> float:
    """The card's top SM clock as ``nvidia-smi`` gives it (clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def attention_bwd_shares(q, k, v, do) -> dict:
    """Each launch's share of one profiled ``flash_attention_bwd`` call's
    device time (the pre-pass, the main kernel, the post-pass), by kernel
    name; empty if the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, S, Hq, D = q.shape
    kw = dict(causal=True, window=0, softcap=0.0, sm_scale=D ** -0.5)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    o = FA._forward(q, k, v, lse=lse, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        for name in ("fa_bwd_prep_kernel", "fa_bwd_main_kernel",
                     "fa_bwd_post_kernel"):
            if name in e.key:
                ms[name] = ms.get(name, 0.0) + e.device_time_total / 1e3
    total = sum(ms.values())
    return {name: {"ms": t, "share": t / total} for name, t in ms.items()}


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
    return {
        "ms": timed_ms(lambda: topk_select(scores, k), 200, flush),
        "plain_ms": timed_ms(lambda: topk_select_ref(scores, k), 50, flush),
        "library_ms": timed_ms(lambda: torch.topk(scores, k), 200, flush),
        **bound(TS.cost(scores.shape[0], k, scores.element_size()),
                scores.dtype),
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
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
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
        t = {"ms": timed_ms(lambda: dot_interaction(x), 200, flush),
             "plain_ms": timed_ms(lambda: dot_interaction_ref(x), 100,
                                  flush),
             "yardstick_ms": timed_ms(lambda: yardstick(x), 100, flush),
             # one read-only pass over the input: the floor a kernel that
             # reads these bytes meets under the same flush
             "read_ms": timed_ms(lambda: x.sum(), 100, flush),
             **bound(DI.cost(B, DLRM_F, DLRM_D, 4), torch.float32)}
        rows[B] = t
        log(f"dot_interaction @B={B} F={DLRM_F} D={DLRM_D} f32: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.bmm + "
            f"triangle gather (two library calls) {t['yardstick_ms']:.4f} "
            f"ms, one read-only pass over x (torch.sum) {t['read_ms']:.4f} "
            f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']}: {t['bytes']} "
            f"B, {t['flops']} FLOP)")
    t = rows[ENGINE_BATCH]             # the DLRM engine's micro-batch
    fwd = {"name": "dot_interaction", "route": "cuda",
           "source": "src/repro_torch/csrc/dot_interaction.cu",
           "replaces": "src/repro/kernels/dot_interaction.py:48",
           "max_abs_err": max(worst.values()), "ms": t["ms"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": None,
           "b4096_ms": rows[BATCH]["ms"],
           "yardstick_ms": t["yardstick_ms"], "read_ms": t["read_ms"]}
    return fwd, dot_interaction_backward(inputs, flush, gen, dev)


def dot_interaction_backward(inputs: dict, flush, gen, dev) -> dict:
    """``dot_interaction`` at DLRM's training batch (65536, 27, 128) f32
    and ``dot_interaction_bwd`` at the kernel phase's shapes in both types
    and at that batch, each against its plain version within BWD_REL_TOL
    of the plain output's max abs; then
    timed at the training batch beside its bound, the plain version and
    the library's time for the same function (the autograd backward of
    ``torch.bmm`` plus the triangle gather, timing only)."""
    B = DLRM_TRAIN_BATCH
    x = (torch.randn((B, DLRM_F, DLRM_D), generator=gen, device=dev)
         * DLRM_D ** -0.5)
    fwd_err, fwd_rel = rel_err(dot_interaction(x), dot_interaction_ref(x))
    if fwd_rel > BWD_REL_TOL[torch.float32]:
        raise AssertionError(f"dot_interaction B={B} F={DLRM_F} D={DLRM_D}: "
                             f"max abs err {fwd_err} = {fwd_rel} of the plain "
                             f"output's max")
    cases = dict(inputs)
    cases[(B, DLRM_F, DLRM_D, torch.float32)] = x
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_abs = 0.0
    for (b, n_f, d, dtype), xx in cases.items():
        g = torch.randn((b, n_f * (n_f - 1) // 2), generator=gen,
                        device=dev).to(dtype)
        got = dot_interaction_bwd(xx, g)
        err, rel = rel_err(got, dot_interaction_bwd_ref(xx, g))
        if got.shape != xx.shape or got.dtype != dtype \
                or not torch.isfinite(got.float()).all() \
                or rel > BWD_REL_TOL[dtype]:
            raise AssertionError(f"dot_interaction_bwd {dtype} B={b} F={n_f}"
                                 f" D={d}: max abs err {err} = {rel} of the "
                                 f"plain output's max")
        worst[dtype] = max(worst[dtype], rel)
        worst_abs = max(worst_abs, err)
    g = torch.randn((B, DLRM_F * (DLRM_F - 1) // 2), generator=gen,
                    device=dev)
    if not same_bits(dot_interaction_bwd(x, g), dot_interaction_bwd(x, g)):
        raise AssertionError(f"dot_interaction_bwd B={B}: two calls gave "
                             f"different bits")
    iu, ju = triu_pairs(DLRM_F, dev)
    xl = x.detach().requires_grad_(True)
    tri = torch.bmm(xl, xl.transpose(1, 2))[:, iu, ju]

    def library():
        return torch.autograd.grad(tri, xl, g, retain_graph=True)

    t = {"ms": timed_ms(lambda: dot_interaction_bwd(x, g), 50, flush),
         "plain_ms": timed_ms(lambda: dot_interaction_bwd_ref(x, g), 10,
                              flush),
         "library_ms": timed_ms(library, 20, flush),
         "fwd_ms": timed_ms(lambda: dot_interaction(x), 50, flush),
         **bound(DI.cost(B, DLRM_F, DLRM_D, 4, backward=True),
                 torch.float32)}
    log(f"dot_interaction_bwd: {len(cases)} shapes within tolerance of the "
        f"plain version (of its max abs: f32 {worst[torch.float32]:.3e} <= "
        f"{F32_ATOL}, bf16 {worst[torch.bfloat16]:.3e} <= {BF16_ATOL}); @B="
        f"{B} F={DLRM_F} D={DLRM_D} f32: kernel {t['ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, autograd of torch.bmm + triangle gather "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP), two calls "
        f"equal bit for bit; the forward at this "
        f"batch {t['fwd_ms']:.4f} ms, within {fwd_rel:.3e} of the plain "
        f"output's max (<= {F32_ATOL})")
    del tri, xl
    return {"name": "dot_interaction_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/dot_interaction_bwd.cu",
            "replaces": "src/repro/kernels/dot_interaction.py:48 (its "
                        "gradient: jax.grad of the einsum and gather)",
            "max_abs_err": worst_abs, "rel_err": max(worst.values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "fwd_b65536_ms": t["fwd_ms"],
            "fwd_b65536_rel_err": fwd_rel, "repeat_bits": True}


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
    lse = decode_lse_check(q, k, v, lengths, flush)
    return {"name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:83",
            "max_abs_err": max(worst, lse["max_abs_err"]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "full_ms": full["ms"], "full_library_ms": full["library_ms"],
            "full_bound_ms": full["bound_ms"], "lse": lse}


def decode_lse_check(q, k, v, lengths, flush) -> dict:
    """The lse instance at the decode shape (row 0 at length 0): its o
    equals the serving instance's bit for bit; its lse is within
    BF16_ATOL of the plain version's, -inf where the plain one is; and
    the two halves of the cache, each through the kernel with its lse,
    merged by their lse (the sequence-sharded decode's merge), are
    within BF16_ATOL of one call over the whole cache. Then its time
    beside the plain version's, SDPA's and its bound."""
    lens = lengths.clone()
    lens[0] = 0
    L = k.shape[1]
    o1 = flash_decode(q, k, v, lens)
    o2, lse = flash_decode(q, k, v, lens, return_lse=True)
    _, lse_ref = flash_decode_ref(q, k, v, lens, return_lse=True)
    fin = torch.isfinite(lse_ref)
    if not torch.equal(o1, o2) or not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError("flash_decode lse instance: o differs from the "
                             "serving instance's, or -inf rows differ")
    lse_err = max_err(lse[fin], lse_ref[fin])
    parts = [flash_decode(q, k[:, lo:lo + L // 2].contiguous(),
                          v[:, lo:lo + L // 2].contiguous(),
                          (lens - lo).clamp(0, L // 2).to(torch.int32),
                          return_lse=True) for lo in (0, L // 2)]
    m = torch.maximum(parts[0][1], parts[1][1])
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = [torch.exp(s - m) for _, s in parts]
    den = w[0] + w[1]
    merged = (w[0][..., None] * parts[0][0].float()
              + w[1][..., None] * parts[1][0].float()) \
        / torch.where(den > 0, den, torch.ones_like(den))[..., None]
    merge_err = max_err(merged, o1)
    if not (lse_err <= BF16_ATOL and merge_err <= BF16_ATOL):
        raise AssertionError(f"flash_decode lse: lse err {lse_err}, merge "
                             f"err {merge_err} > {BF16_ATOL}")
    t = decode_timing(q, k, v, lengths, flush, 0, return_lse=True)
    log(f"flash_decode lse instance @decode shape: lse max abs err "
        f"{lse_err:.3e} vs the plain version (length-0 row -inf on both), o "
        f"equal to the serving instance's; two halves merged by their lse "
        f"vs one call: max abs err {merge_err:.3e} (<= {BF16_ATOL}); kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_lse_ms']:.4f} ms, sdpa "
        f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
        f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP)")
    return {"max_abs_err": max(lse_err, merge_err), "lse_err": lse_err,
            "merge_err": merge_err, "ms": t["ms"],
            "plain_ms": t["plain_lse_ms"], "library_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"]}


def decode_timing(q, k, v, lengths, flush, plain_iters: int,
                  window: int = 0, softcap: float = 0.0, scale=None,
                  return_lse: bool = False) -> dict:
    """The decode kernel (its lse instance with ``return_lse``), SDPA with
    a boolean length (and window) mask and, with ``plain_iters``, the
    plain version at one set of lengths, L2 flushed between launches; the
    bound from the valid cache rows' bytes. SDPA has no softcap: with
    one, its error is against the plain version without it."""
    B, L, Hkv, D = k.shape
    Hq = q.shape[1]
    kw = dict(window=window, softcap=softcap, sm_scale=scale,
              return_lse=return_lse)
    pos = torch.arange(L, device=q.device)
    ok = pos[None, :] < lengths[:, None]
    if window > 0:
        ok &= pos[None, :] >= lengths[:, None] - window
    mask = ok[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, scale=scale, enable_gqa=True)[:, :, 0]

    n_valid = int(ok.sum())
    return {
        "ms": timed_ms(lambda: flash_decode(q, k, v, lengths, **kw), 200,
                       flush),
        "plain_ms": (timed_ms(lambda: flash_decode_ref(q, k, v, lengths,
                                                       **kw),
                              plain_iters, flush) if plain_iters else None),
        "library_ms": timed_ms(library, 100, flush),
        "library_err": max_err(library(), flash_decode_ref(
            q, k, v, lengths, window=window, sm_scale=scale)),
        "plain_lse_ms": (timed_ms(lambda: flash_decode_ref(
            q, k, v, lengths, **kw), 20, flush) if return_lse else None),
        "piece": piece_length(B, Hkv, L, q.dtype, D),
        "mean_length": n_valid / B,
        **bound(FD.cost(B, Hq, Hkv, D, q.element_size(), n_valid,
                        return_lse), q.dtype)}


def tma_decode_checks(q, k, v, lengths, kw: dict, label: str) -> dict:
    """The TMA instance at a timed decode row: two calls equal bit for
    bit; with ``return_lse`` (row 0 at length 0) its o equal to the
    serving call's, zeros in row 0, and its lse within BF16_ATOL of the
    plain lse, -inf where the plain one is; NaN written into the caches
    past every row's length and before its window leaves the output equal
    to the clean call's bit for bit."""
    o1 = flash_decode(q, k, v, lengths, **kw)
    if not same_bits(o1, flash_decode(q, k, v, lengths, **kw)):
        raise AssertionError(f"flash_decode {label}: two calls gave "
                             f"different bits")
    lens = lengths.clone()
    lens[0] = 0
    o2, lse = flash_decode(q, k, v, lens, return_lse=True, **kw)
    _, lse_ref = flash_decode_ref(q, k, v, lens, return_lse=True, **kw)
    fin = torch.isfinite(lse_ref)
    lse_err = max_err(lse[fin], lse_ref[fin])
    if not same_bits(o2, flash_decode(q, k, v, lens, **kw)) \
            or o2[0].any() or not torch.equal(fin, torch.isfinite(lse)) \
            or lse_err > BF16_ATOL:
        raise AssertionError(f"flash_decode {label} with the lse: lse err "
                             f"{lse_err}, or o differs from the serving "
                             f"call's, or a length-0 row is not zero / -inf")
    L = k.shape[1]
    pos = torch.arange(L, device=q.device)[None, :]
    bad = pos >= lengths[:, None]
    if kw["window"] > 0:
        bad |= pos < lengths[:, None] - kw["window"]
    kp, vp = k.clone(), v.clone()
    kp[bad], vp[bad] = float("nan"), float("nan")
    poisoned = flash_decode(q, kp, vp, lengths, **kw)
    torch.cuda.synchronize()
    if not same_bits(poisoned, o1):
        raise AssertionError(f"flash_decode {label}: NaN outside the valid "
                             f"range reached the output")
    n_bad = int(bad.sum())
    del kp, vp, bad
    return {"repeat_bits": True, "lse_err": lse_err,
            "nan_positions": n_bad, "nan_kept_out": True}


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


class DrainBatch:
    """One micro-batch as ``DrainExecutor`` takes it."""

    def __init__(self, i, keys, buckets, feats, n):
        self.i, self.item_keys, self.buckets = i, keys, buckets
        self.features, self.n_valid = feats, n


def drain_batches(mk, n_batches: int, seed: int, fseed: int) -> list:
    """Seeded micro-batches of BATCH // 2 to BATCH valid items; a third of
    each batch repeats keys already served."""
    r = np.random.default_rng(seed)
    batches = []
    for i in range(n_batches):
        n = int(r.integers(BATCH // 2, BATCH + 1))
        keys = np.zeros(BATCH, np.uint32)
        keys[:n] = np.where(r.random(n) < 1 / 3,
                            r.integers(1, 1 + 4 * BATCH, n),
                            r.integers(1 << 20, 1 << 31, n)).astype(np.uint32)
        batches.append((i, keys, np.zeros(BATCH, np.int32),
                        mk(BATCH, fseed=fseed + i), n))
    return batches


def phase_serving(cfg: TrustIRConfig, evaluate, mk, dev, *,
                  label: str = "serving", n_attn: int = N_LAYERS,
                  n_head: int = 1, n_batches: int = 8, max_evals: int = 0,
                  seed: int = SEED, fseed: int = 1000,
                  probe_sync: bool = True, warm_up: bool = False):
    """DrainExecutor(depth=2) serves ``n_batches`` seeded micro-batches on
    the wall clock, then flushes; every kernel's launches are read around
    this run (``n_attn`` flash_attention and ``n_head`` score_head
    launches a batch). ``max_evals``
    caps the evaluator's rows (0 = the whole batch). ``probe_sync`` first
    checks that dispatch never waits for the card; ``warm_up`` runs one
    more batch before the clock starts. Returns (stats, the shedder)."""
    batches = drain_batches(mk, n_batches + warm_up, seed, fseed)
    if probe_sync:
        # Under sync debug mode "error" any implicit host-device sync in
        # dispatch_staged raises.
        probe = FusedLoadShedder(cfg, evaluate, device=dev)
        _, keys, buckets, feats, n = batches[0]
        staged = probe.stage(keys, buckets, feats, n_valid=n)
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = probe.dispatch_staged(staged)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        pending.result()
        log(f"{label}: dispatch_staged: no host-device sync under sync "
            f"debug mode 'error'")

    fused = FusedLoadShedder(cfg, evaluate, max_evals=max_evals or None,
                             device=dev)
    if warm_up:
        _, keys, buckets, feats, n = batches.pop()
        fused.process(keys, buckets, feats, n_valid=n)
    results = {}

    def finalize(batch, shed):
        if batch.i in results:
            raise AssertionError(f"{label}: batch {batch.i} answered twice")
        results[batch.i] = shed
        return [batch.i]

    ex = DrainExecutor(fused, finalize, depth=2)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    for b in batches:
        ex.submit(DrainBatch(*b))
    ex.flush()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: w.launches for name, w in KERNELS.items()}
    note_instances(label)
    want = {name: 0 for name in KERNELS}
    want["shed_partition"] = n_batches
    want["flash_attention"] = n_attn * n_batches
    want["score_head"] = n_head * n_batches
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{want}")

    if sorted(results) != list(range(n_batches)):
        raise AssertionError(f"{label}: answered {sorted(results)}")
    items = evals = 0
    for i, _keys, _b, _f, n in batches:
        res = results[i]
        if (res.tier[:n] == TIER_INVALID).any() \
                or (res.tier[n:] != TIER_INVALID).any():
            raise AssertionError(f"{label}: batch {i} dropped an item")
        if res.trust.shape != (BATCH,) or not np.isfinite(res.trust).all() \
                or res.trust.min() < 0 or res.trust.max() > cfg.trust_scale:
            raise AssertionError(f"{label}: batch {i} trust malformed or "
                                 f"outside [0, {cfg.trust_scale}]")
        if max_evals and res.n_evaluated > max_evals:
            raise AssertionError(f"{label}: {res.n_evaluated} evaluations "
                                 f"over the cap {max_evals}")
        items += n
        evals += res.n_evaluated
    lat = np.array([results[i].response_time_s for i in range(n_batches)])
    stats = {"batches": n_batches, "items": items, "wall_s": wall,
             "items_per_s": items / wall, "evals_per_s": evals / wall,
             "p50_batch_latency_s": float(np.percentile(lat, 50)),
             "p99_batch_latency_s": float(np.percentile(lat, 99)),
             "regimes": [results[i].regime.name for i in range(n_batches)],
             "n_evaluated": [results[i].n_evaluated
                             for i in range(n_batches)],
             "n_cached": [results[i].n_cached for i in range(n_batches)],
             "launches": launches, "max_evals": max_evals}
    log(f"{label} (DrainExecutor depth 2, wall clock): {n_batches} batches, "
        f"{items} items ({evals} evaluated, at most {max_evals or 'all'} a "
        f"batch) in {wall:.3f} s = {stats['items_per_s']:.1f} items/s, "
        f"{stats['evals_per_s']:.1f} evaluated/s, p50 batch latency "
        f"{stats['p50_batch_latency_s'] * 1e3:.1f} ms, p99 "
        f"{stats['p99_batch_latency_s'] * 1e3:.1f} ms; regimes "
        f"{stats['regimes']}; launches {launches}")
    return stats, fused


KERNEL_GROUPS = (
    ("flash_attention backward kernels", ("fa_bwd_prep_kernel",
                                          "fa_bwd_main_kernel",
                                          "fa_bwd_post_kernel",
                                          "dq_bf16_kernel",
                                          "dkdv_bf16_kernel",
                                          "dq_f32_kernel", "dkdv_f32_kernel",
                                          "di_kernel")),
    ("dot_interaction backward kernel", ("dot_interaction_bwd_kernel",)),
    ("shed_partition kernel", ("shed_partition_kernel",)),
    ("flash_attention kernel", ("flash_attention_bf16_kernel",
                                "fa_fwd_wgmma_kernel",
                                "fa_fwd_short_kernel",
                                "flash_attention_f32_kernel")),
    ("dot_interaction kernel", ("dot_interaction_kernel",)),
    ("flash_decode kernel", ("flash_decode_pieces_kernel",
                             "flash_decode_combine_kernel",
                             "flash_decode_tma_kernel",
                             "flash_decode_tma_combine_kernel")),
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
    decode = {}
    for e in kernels:
        name = re.search(r"flash_decode_\w+", e.key)
        if name:
            ms_count = decode.setdefault(name.group(0), [0.0, 0])
            ms_count[0] += e.device_time_total / 1e3
            ms_count[1] += e.count
    for name, (ms, count) in decode.items():
        log(f"  {name}: {ms:.3f} ms x{count} = {ms / count:.4f} ms a launch")
    return {"wall_ms": wall * 1e3, "busy_ms": busy_ms,
            "busy_share": busy_ms / (wall * 1e3),
            "launches": sum(e.count for e in kernels), "groups_ms": groups,
            "flash_decode_kernels": decode}


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
    reset_launches()
    if isinstance(evaluate, CountedEvaluator):
        evaluate.calls = 0
    t0 = time.monotonic()
    rids = serve_queries(eng, queries)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {name: w.launches for name, w in KERNELS.items()}
    note_instances(label)

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
    reset_launches()
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
    note_instances("fleet")
    want_topk = sum(n for n, _ in runs)
    retrieve_s = sum(t for _, t in runs)

    st = coord.scheduler_stats()
    n_batches = st["n_batches"] - base["n_batches"]
    n_items = st["n_batched_items"] - base["n_batched_items"]
    want = {"topk_select": want_topk, "shed_partition": n_batches,
            "flash_attention": N_LAYERS * n_batches, "dot_interaction": 0,
            "flash_decode": 0, **NO_BACKWARD, "score_head": n_batches}
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
        reset_launches()
    t1 = time.monotonic()
    rep = run_churn_workload(coord, timed, wl, events)
    torch.cuda.synchronize()
    wall = time.monotonic() - t1
    launches = {name: w.launches for name, w in KERNELS.items()}
    if counted:
        note_instances("fanout")
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
            "dot_interaction": 0, "flash_decode": 0, **NO_BACKWARD,
            "score_head": st["n_batches"]}
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
                "flash_decode": 0, **NO_BACKWARD, "score_head": 0}

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
# phase 10a: the mesh-sharded serving path on a (1, 1) mesh
# ---------------------------------------------------------------------------

def sharded_requests(mk, n: int, seed: int) -> list:
    """``n`` seeded requests of SHARDED_REQUEST items (two fill a
    BATCH-item micro-batch); a third of the keys repeat earlier ones."""
    r = np.random.default_rng(seed)
    out = []
    for i in range(n):
        keys = np.where(r.random(SHARDED_REQUEST) < 1 / 3,
                        r.integers(1, 1 + 4 * BATCH, SHARDED_REQUEST),
                        r.integers(1 << 20, 1 << 31, SHARDED_REQUEST)
                        ).astype(np.uint32)
        out.append((keys, r.integers(0, 64, SHARDED_REQUEST
                                     ).astype(np.int32),
                    mk(SHARDED_REQUEST, fseed=seed + i)))
    return out


def sharded_engine(cfg: TrustIRConfig, evaluate, dev, sim: bool,
                   feature_sharding=None) -> ServingEngine:
    return ServingEngine(
        cfg, evaluate, drain_mode="fused", evaluate_batch=evaluate,
        feature_sharding=feature_sharding, device=dev,
        sim_clock=SimClock(cfg.u_capacity / cfg.deadline_s) if sim else None,
        sched_cfg=SchedulerConfig(max_batch_items=BATCH))


def drive_engine(eng, requests) -> tuple:
    """Requests enqueued a micro-batch's worth at a time, each time one
    batch drained with the window left open; a flush at the end. Returns
    (request ids, the responses by id); fails if one is answered twice
    or not at all."""
    rids = []
    per_batch = max(BATCH // SHARDED_REQUEST, 1)
    for i, (keys, buckets, feats) in enumerate(requests):
        rids.append(eng.enqueue(keys, buckets, feats, slo_s=10.0))
        if (i + 1) % per_batch == 0:
            eng.drain(max_batches=1, flush=False)
    eng.flush()
    got = [r.request_id for r in eng.completed]
    if sorted(got) != sorted(rids) or len(set(got)) != len(got):
        raise AssertionError(f"{len(rids)} requests, answers {got}")
    return rids, {r.request_id: r for r in eng.completed}


def phase_sharded(evaluate, mk, dev) -> dict:
    """The mesh-sharded serving path on the (1, 1) mesh of this card, a
    world of one made by ``make_host_mesh``:

    1. full-width smollm-135m, ``make_sharded_evaluator`` over the
       replicated evaluator's own weights, through
       ``ServingEngine(drain_mode="fused", feature_sharding=...)`` at
       depth 2 and BATCH-item micro-batches: on SimClocks the same
       requests through the replicated and the sharded engine give equal
       regimes, tiers and counts and trust bit for bit; on the wall
       clock both serve SHARDED_REQUESTS requests, in turns (replicated,
       sharded, sharded, replicated), every request answered once; the
       sharded runs' launches are the path's;
    2. dlrm-mlperf at its published widths, tables capped at
       DLRM_ROW_CAP rows (53 GB), sharded over the replicated
       evaluator's tensors (no copy), scores within DLRM_SHARDED_ATOL of
       the replicated ones on BATCH items, then a sharded fused engine
       run whose ``dot_interaction`` launches are the path's;
    3. ``serve --sharded --sync --drain-mode fused`` at smoke width
       through the launcher's ``main``, on the card by default, exiting
       0 and ending the world it made.

    The process group is destroyed before the phase returns."""
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.serving.evaluators import make_sharded_evaluator
    t_phase = time.monotonic()
    mesh = make_host_mesh((1, 1))
    launches = {name: 0 for name in KERNELS}
    try:
        if mesh.device_type != "cuda" or tuple(mesh.shape) != (1, 1):
            raise AssertionError(f"host mesh {mesh}")
        se = make_sharded_evaluator("smollm-135m", mesh=mesh,
                                    params=evaluate.params)
        cfg = TrustIRConfig(drain_mode="fused", pipeline_depth=2)
        requests = sharded_requests(mk, SHARDED_REQUESTS, SEED + 11)
        # SimClock parity: the same decisions, so the same trust bits
        runs = {}
        for name, ev, fs in (("replicated", evaluate, None),
                             ("sharded", se.evaluate, se.feature_sharding)):
            rids, resp = drive_engine(sharded_engine(cfg, ev, dev, True, fs),
                                      requests)
            runs[name] = [resp[i] for i in rids]
        worst = 0.0
        for a, b in zip(runs["replicated"], runs["sharded"]):
            if (a.admitted, a.reason, int(a.shed.regime), a.shed.n_evaluated,
                    a.shed.n_cached, a.shed.n_prior) != \
                    (b.admitted, b.reason, int(b.shed.regime),
                     b.shed.n_evaluated, b.shed.n_cached, b.shed.n_prior) \
                    or not np.array_equal(a.tier, b.tier):
                raise AssertionError(f"request {a.request_id}: sharded and "
                                     f"replicated engines disagree")
            worst = max(worst, float(np.abs(a.trust - b.trust).max()))
        bits = all(np.array_equal(a.trust, b.trust) for a, b in
                   zip(runs["replicated"], runs["sharded"]))
        if worst > TRUST_ATOL:
            raise AssertionError(f"sharded vs replicated trust {worst}")
        regimes = sorted({r.shed.regime.name for r in runs["sharded"]})
        log(f"sharded smollm-135m (SimClock, {len(requests)} requests of "
            f"{SHARDED_REQUEST} items, {BATCH}-item batches): regimes "
            f"{regimes}, tiers and counts equal to the replicated engine's, "
            + ("trust equal bit for bit" if bits else
               f"trust NOT bit-equal: max diff {worst:.3e} <= {TRUST_ATOL} "
               f"(bf16 evaluator)"))
        # wall clock, in turns
        rates = {"replicated": [], "sharded": []}
        for name in ("replicated", "sharded", "sharded", "replicated"):
            sharded = name == "sharded"
            eng = sharded_engine(cfg, se.evaluate if sharded else evaluate,
                                 dev, False,
                                 se.feature_sharding if sharded else None)
            drive_engine(eng, requests[:4])          # warm-up batches
            eng.completed.clear()
            base = eng.scheduler.stats.as_dict()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.monotonic()
            rids, resp = drive_engine(eng, requests)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            got = read_launches()
            note_instances(name)
            st = eng.scheduler.stats.as_dict()
            n_batches = st["n_batches"] - base["n_batches"]
            items = st["n_batched_items"] - base["n_batched_items"]
            want = {n: 0 for n in KERNELS}
            want["shed_partition"] = n_batches
            want["flash_attention"] = N_LAYERS * n_batches
            # a vocabulary "sharded" over this (1, 1) mesh is whole here
            want["score_head"] = n_batches
            if got != want:
                raise AssertionError(f"{name} engine: launches {got}, "
                                     f"expected {want}")
            for r in resp.values():
                if (r.tier == TIER_INVALID).any() \
                        or not np.isfinite(r.trust).all():
                    raise AssertionError(f"{name} engine: request "
                                         f"{r.request_id} malformed")
            rates[name].append(items / wall)
            if sharded:
                for n in KERNELS:
                    launches[n] += got[n]
            log(f"sharded phase, {name} engine (wall clock, depth 2): "
                f"{len(rids)} requests, {n_batches} batches, {items} items "
                f"in {wall:.3f} s = {items / wall:.1f} items/s; launches "
                f"{got}")
        log(f"sharded smollm-135m items/s {rates['sharded']} beside the "
            f"replicated drain's {rates['replicated']}")
        del se, runs
        gc.collect()

        # dlrm-mlperf at the engine's cap, sharded over the same tables
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        ev_d, mk_d = make_evaluator("dlrm-mlperf", smoke=False, seed=SEED,
                                    device=dev, max_table_rows=DLRM_ROW_CAP)
        se_d = make_sharded_evaluator("dlrm-mlperf", mesh=mesh,
                                      params=ev_d.params,
                                      max_table_rows=DLRM_ROW_CAP)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        feats = {k: torch.as_tensor(v, device=dev)
                 for k, v in mk_d(BATCH, fseed=SEED + 12).items()}
        a, b = ev_d(feats), se_d.evaluate(feats)
        err = max_err(b, a)
        if err > DLRM_SHARDED_ATOL or not torch.isfinite(b).all():
            raise AssertionError(f"sharded dlrm vs replicated: {err}")
        log(f"sharded dlrm-mlperf ({DLRM_ROW_CAP} rows a table, "
            f"{held / 1e9:.2f} GB held by both evaluators together): "
            f"{BATCH} scores, max |diff| {err:.3e} <= {DLRM_SHARDED_ATOL}"
            + (" (equal bits)" if same_bits(a, b) else ""))
        eng = sharded_engine(cfg, se_d.evaluate, dev, False,
                             se_d.feature_sharding)
        counted = CountedEvaluator(se_d.evaluate)
        eng.shedder.evaluate_batch = counted
        dreq = sharded_requests(mk_d, 8, SEED + 13)
        drive_engine(eng, dreq[:2])                  # warm-up batch
        eng.completed.clear()
        torch.cuda.synchronize()
        reset_launches()
        counted.calls = 0
        t0 = time.monotonic()
        drive_engine(eng, dreq)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        got = read_launches()
        if got["dot_interaction"] != counted.calls or not counted.calls \
                or got["flash_attention"]:
            raise AssertionError(f"sharded dlrm engine: launches {got} for "
                                 f"{counted.calls} evaluator calls")
        for n in KERNELS:
            launches[n] += got[n]
        log(f"sharded dlrm engine (wall clock): {len(dreq)} requests in "
            f"{wall:.3f} s, {counted.calls} evaluator calls; launches {got}")
        del ev_d, se_d, eng, counted, a, b, feats
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        destroy_world()

    # the launcher's entry point, as a user runs it (the card by default);
    # it makes and ends its own world of one
    t0 = time.monotonic()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["--sharded", "--sync", "--drain-mode", "fused",
                         "--corpus", "192", "--n-requests", "3"])
    lines = out.getvalue().strip().splitlines()
    if rc != 0 or not lines \
            or not lines[0].startswith("smollm-135m on cuda") \
            or sum(l.lstrip().startswith("req ") for l in lines) != 3 \
            or not lines[-1].startswith("P50 ") \
            or torch.distributed.is_initialized():
        raise AssertionError(f"serve --sharded: exit {rc}\n{lines}")
    log(f"serve --sharded --sync --drain-mode fused on the card: "
        f"{lines[0]} ... {lines[-1]} ({time.monotonic() - t0:.1f} s)")
    log(f"sharded phase: {time.monotonic() - t_phase:.1f} s; launches "
        f"{launches}")
    return {"launches": launches, "items_per_s": rates,
            "trust_bits_equal": bits, "dlrm_err": err}


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
                    "flash_decode": 0, **NO_BACKWARD, "score_head": 0}

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
    reset_launches()
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
    note_instances("decode prefill")
    scores = torch.cat(scores)
    # a one-token prompt has no next token to score
    n_scored = int((prompt_lens > 1).sum())
    if prefill_launches["flash_attention"] != cfg.n_layers * DECODE_SLOTS \
            or prefill_launches["score_head"] != n_scored \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"prefill: launches {prefill_launches}, "
                             f"finite scores {bool(torch.isfinite(scores).all())}")

    check_slots = (0, 1, DECODE_SLOTS * 3 // 5)  # shortest, longest, one
    check_steps = (0, DECODE_STEPS // 2, DECODE_STEPS - 1)
    kept = {}
    reset_launches()
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
    by_instance = dict(flash_decode.by_instance)
    if by_instance != {"tma": 0, "pieces": want["flash_decode"]}:
        raise AssertionError(f"decode: flash_decode launches by instance "
                             f"{by_instance}, expected all on pieces")
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
             "launches": launches, "by_instance": by_instance,
             "peak_bytes": peak, "logit_err": worst}
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


# ---------------------------------------------------------------------------
# the evaluator families beside smollm: new kernel shapes, gemma2 on the
# main path and in decode, the 14-30 B models and the GCN on the fused
# drain
# ---------------------------------------------------------------------------

def phase_score_head(dev) -> dict:
    """The fused scoring head at the evaluators' steps
    (``time_score_head.SHAPES``): held to the plain chunked path, its
    bits repeated, timed (L2 flushed) beside its bound, the plain path
    and the library yardstick. The paths' own calls are read from their
    runs (``KERNELS``, ``note_instances``)."""
    t0 = time.monotonic()
    flush = l2_flusher(dev)
    rows = [TSH.run_shape(name, dev, flush) for name in TSH.SHAPES]
    for r in rows:
        lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
               else "not measured (its logits do not fit)")
        log(f"score_head {r['shape']} (P {r['P']}, d {r['d']}, V {r['V']}, "
            f"{'tied' if r['tied'] else 'untied'}; the rule's path "
            f"{r['rule']}): kernel {r['kernel_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; "
            f"{100 * r['share_of_bound']:.1f}% of it), plain "
            f"{r['plain_ms']:.4f} ms, cross_entropy {lib}; max |err| "
            f"{r['max_abs_err']:.3e}, {r['beyond_tolerance']} beyond "
            f"tolerance, repeat bits {r['repeat_bits']}")
        if r["beyond_tolerance"] or not r["finite"] or not r["repeat_bits"]:
            raise AssertionError(f"score_head at {r['shape']}: {r}")
    log(f"score_head phase: {time.monotonic() - t0:.1f} s")
    return {"name": "score_head", "shapes": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows)}


def softcap_moves(plain, kw: dict, atol: float, label: str) -> float:
    """How far the softcap moves the plain output on these inputs (capped
    vs uncapped); it must be more than ten tolerances, so that a kernel
    that skipped or misplaced the cap could not pass."""
    capped = plain(**kw)
    uncapped = plain(**{**kw, "softcap": 0.0})
    moved = max_err(capped, uncapped)
    if not moved > 10 * atol:
        raise AssertionError(f"{label}: the softcap moves the plain output "
                             f"by only {moved}")
    return moved


def d256_instances(g2, gen, dev, flush) -> list:
    """gemma2's D 256 forward on the instance ``long_instance`` gives it
    (the ``wgmma`` one from LONG_FROM on) at its training microbatch (B
    2, the lse instance's shape; S 4096, global layer) and its longest
    prefill (S 8000, the local layer's window of 4096): both instances
    (serving: P split; with the lse: bf16 P once) held to the plain
    version within BF16_ATOL, on plain inputs and with the softcap biting
    (q x BITE_Q), two calls equal bit for bit; then timed beside the
    ``mma.sync`` instance it replaced (``long_from=NEVER_LONG``), SDPA
    (no softcap) and the bound. Fails if ptxas spilled or serialised a D
    256 ``wgmma`` instance in this run's build."""
    ptxas = {key: row for key, row in ptxas_report(
        "flash_attention", "fa_fwd_wgmma_kernel").items()
        if key.startswith("D256")}
    if sorted(ptxas) != ["D256", "D256_lse"] or any(
            row.get("spill_stores") != 0 or row.get("wgmma_serialized")
            for row in ptxas.values()):
        raise AssertionError(f"flash_attention: a D 256 wgmma instance "
                             f"spills or serialises its wgmma (this run's "
                             f"ptxas: {ptxas})")
    scale, cap = g2.query_pre_attn_scalar ** -0.5, g2.attn_logit_softcap
    rows = []
    for label, B, S, window in (
            ("gemma2 training forward", 2, TRAIN_SEQ, 0),
            ("gemma2 longest prefill, local layer", 1, GEMMA_MAX_PROMPT,
             g2.sliding_window)):
        q, k, v = attention_inputs(B, S, g2.n_heads, g2.n_kv_heads,
                                   g2.d_head, torch.bfloat16, gen, dev)
        kw = dict(window=window, softcap=cap, scale=scale)
        check = {"plain": forward_check(q, k, v, label, **kw),
                 "softcap biting": forward_check(
                     (q.float() * BITE_Q).to(q.dtype), k, v,
                     f"{label}, softcap biting", **kw)}
        t = attention_timing(q, k, v, flush, plain_iters=0, **kw)
        lse = torch.empty((B, g2.n_heads, S), dtype=torch.float32,
                          device=dev)
        lse_ms = timed_ms(lambda: FA._forward(
            q, k, v, True, window, cap, scale, lse), 20, flush)
        old = mma_sync_ms(q, k, v, flush, **kw)
        row = {"shape": f"{label}: B={B} S={S} {g2.n_heads}/"
                        f"{g2.n_kv_heads} heads D={g2.d_head} bf16 "
                        f"window={window} softcap={cap}",
               "instance": instance_of(q, k, window, cap),
               "max_abs_err": max(max(c["max_abs_err"].values())
                                  for c in check.values()),
               "ms": t["ms"], "lse_ms": lse_ms,
               "mma_sync_ms": old["ms"], "mma_sync_lse_ms": old["lse_ms"],
               "library_ms": t["library_ms"], "library": "sdpa, no softcap",
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "plain_ms": None, "checks": check, "ptxas": ptxas}
        log(f"flash_attention {row['shape']} ({row['instance']}): serving "
            f"(P split) {t['ms']:.4f} ms, with the lse (bf16 P once) "
            f"{lse_ms:.4f} ms; the mma.sync instance {old['ms']:.4f} / "
            f"{old['lse_ms']:.4f} ms; sdpa (no softcap) "
            f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP); "
            f"{json.dumps(check)}; ptxas {json.dumps(ptxas)}")
        rows.append(row)
        del q, k, v, lse
    return rows


def phase_new_head_dims(dev) -> dict:
    """``flash_attention`` and ``flash_decode`` at the heads the new
    evaluators give them, each against its plain version, then timed
    beside its bound and SDPA: D 256 with gemma2's softcap 50 and
    1/sqrt(256) scale (window 4096 on local layers) at the evaluator's
    batch, the longest prefill and the decode shape; the qwen2.5 heads
    (40/8, D 128), qwen3-moe's (32/4, D 128) and moonshot's (16/16, D 128)
    at their fused batches; and the qwen2.5 smoke head (D 12, zero-padded
    to 16) in float32. The cases marked to bite scale q by BITE_Q, so that
    the logits reach 30-100 and the softcap moves the plain output by more
    than ten tolerances (checked) while the kernel stays within one."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    g2, qw = get_config(GEMMA), get_config("qwen2.5-14b")
    q3, ms = get_config("qwen3-moe-30b-a3b"), get_config("moonshot-v1-16b-a3b")
    qs = get_config("qwen2.5-14b", smoke=True)
    S, bf, f32 = DOC_LEN - 1, torch.bfloat16, torch.float32
    scale = g2.query_pre_attn_scalar ** -0.5
    cap, win = g2.attn_logit_softcap, g2.sliding_window
    evals = {arch: cap_ or BATCH for arch, cap_ in BIG_EVALUATORS}
    flush = l2_flusher(dev)
    # label, B, S, config, dtype, window, softcap, scale, time it, bite
    cases = [("gemma2 evaluator, local layer", BATCH, S, g2, bf, win, cap,
              scale, True, False),
             ("gemma2 evaluator, global layer", BATCH, S, g2, bf, 0, cap,
              scale, False, False),
             ("gemma2 evaluator, local layer, softcap biting", BATCH, S, g2,
              bf, win, cap, scale, False, True),
             ("gemma2 longest prefill, local layer", 1, GEMMA_MAX_PROMPT,
              g2, bf, win, cap, scale, True, False),
             ("gemma2 longest prefill, softcap biting", 1, GEMMA_MAX_PROMPT,
              g2, bf, win, cap, scale, False, True),
             ("gemma2 f32", 64, S, g2, f32, win, cap, scale, False, False),
             ("gemma2 f32, softcap biting", 64, S, g2, f32, win, cap, scale,
              False, True),
             ("qwen2.5-14b evaluator", evals["qwen2.5-14b"], S, qw, bf, 0,
              0.0, None, True, False),
             ("qwen3-moe-30b-a3b evaluator", evals["qwen3-moe-30b-a3b"], S,
              q3, bf, 0, 0.0, None, True, False),
             ("moonshot-v1-16b-a3b evaluator", evals["moonshot-v1-16b-a3b"],
              S, ms, bf, 0, 0.0, None, True, False),
             ("qwen2.5-14b smoke, D 12 padded", 64, S, qs, f32, 0, 0.0,
              None, False, False)]
    attn, worst_attn = [], 0.0
    for label, B, s_len, c, dt, w, sc, scl, timed, bite in cases:
        q, k, v = attention_inputs(B, s_len, c.n_heads, c.n_kv_heads,
                                   c.d_head, dt, gen, dev)
        if bite:
            q = (q.float() * BITE_Q).to(dt)
        kw = dict(causal=True, window=w, softcap=sc, sm_scale=scl)
        before = flash_attention.launches
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        atol = BF16_ATOL if dt == bf else F32_ATOL
        if flash_attention.launches != before + 1 or got.shape != q.shape \
                or not torch.isfinite(got).all() or err > atol:
            raise AssertionError(f"flash_attention {label}: max abs err "
                                 f"{err} > {atol}")
        worst_attn = max(worst_attn, err) if dt == bf else worst_attn
        row = {"shape": f"{label}: B={B} S={s_len} {c.n_heads}/"
                        f"{c.n_kv_heads} heads D={c.d_head} {dt} window={w}"
                        f" softcap={sc}", "max_abs_err": err}
        msg = f"flash_attention {row['shape']}: max abs err {err:.3e}"
        if bite:
            row["softcap_moves_plain"] = softcap_moves(
                lambda **kw_: flash_attention_ref(q, k, v, **kw_), kw, atol,
                f"flash_attention {label}")
            msg += (f"; the softcap moves the plain output by "
                    f"{row['softcap_moves_plain']:.3e}")
        if timed:
            t = attention_timing(q, k, v, flush, plain_iters=3 if B > 1
                                 else 0, window=w, softcap=sc, scale=scl)
            row.update({key: t[key] for key in ("ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by")})
            row["library"] = "sdpa, no softcap" if sc else "sdpa"
            msg += (f"; kernel {t['ms']:.4f} ms, plain "
                    f"{t['plain_ms'] if t['plain_ms'] is None else round(t['plain_ms'], 4)}"
                    f" ms, {row['library']} {t['library_ms']:.4f} ms, bound "
                    f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']}"
                    f" B, {t['flops']} FLOP)")
            row["instance"] = instance_of(q, k, w, sc)
            if row["instance"] == "short":   # the Qwen models' S 31
                row["short"] = short_row(q, k, v, flush, label, t)
                worst_attn = max(worst_attn, row["short"]["check"][
                    "max_abs_err"]["serving"])
        log(msg)
        attn.append(row)
        del q, k, v, got, want
    d256 = d256_instances(g2, gen, dev, flush)
    attn += d256
    worst_attn = max([worst_attn] + [r["max_abs_err"] for r in d256])

    # the backward at every head dimension the forward has, in both
    # types, with windows and biting softcaps, and rows handed an lse of
    # -inf (no causal or windowed mask leaves a row without a key)
    # label, B, S, Hq, Hkv, D, dtype, window, softcap, bite, dead rows
    bcases = [("smoke heads", 8, 64, 4, 2, 16, f32, 0, 0.0, False, 0),
              ("D 16, window", 4, 300, 4, 2, 16, bf, 64, 0.0, False, 0),
              ("qwen2.5-14b heads, window", 2, 512, 40, 8, 128, bf, 128, 0.0,
               False, 0),
              ("D 128 f32", 2, 200, 8, 2, 128, f32, 0, 0.0, False, 0),
              ("gemma2 heads, window, softcap biting", 2, 600, 8, 4, 256, bf,
               256, cap, True, 0),
              ("gemma2 heads f32, window, softcap biting", 2, 200, 8, 4, 256,
               f32, 64, cap, True, 0),
              ("smollm heads, rows without a key", 2, 300, 9, 3, 64, bf, 0,
               0.0, False, 50),
              ("gemma2 heads, rows without a key", 1, 200, 8, 4, 256, bf, 32,
               cap, False, 20)]
    bwd, worst_bwd = [], 0.0
    for label, B, s_len, hq, hkv, d, dt, w, sc, bite, dead in bcases:
        q, k, v, do = attention_inputs(B, s_len, hq, hkv, d, dt, gen, dev) \
            + (torch.randn((B, s_len, hq, d), generator=gen,
                           device=dev).to(dt),)
        if bite:
            q = (q.float() * BITE_Q).to(dt)
        kw = dict(causal=True, window=w, softcap=sc)
        row = attention_bwd_check(q, k, v, do, kw, label, dead_rows=dead)
        msg = (f"flash_attention_bwd {row['shape']}: dq/dk/dv within "
               f"{row['dq_rel_err']:.3e}/{row['dk_rel_err']:.3e}/"
               f"{row['dv_rel_err']:.3e} of the plain output's max, the "
               f"lse instance's o {row['o_rel_err']:.3e}, lse "
               f"{row['lse_max_abs_err']:.3e}")
        if bite:
            row["softcap_moves_plain"] = softcap_moves(
                lambda **kw_: flash_attention_ref(q, k, v, **kw_), kw,
                BWD_REL_TOL[dt], f"flash_attention_bwd {label}")
            msg += (f"; the softcap moves the plain forward by "
                    f"{row['softcap_moves_plain']:.3e}")
        if dead:
            msg += f"; {row['rows_without_key']} rows without a key: dq 0"
        log(msg)
        bwd.append(row)
        worst_bwd = max(worst_bwd, row["max_abs_err"])
        del q, k, v, do

    decode, worst_dec = [], 0.0
    L_, B_ = GEMMA_MAX_LEN, GEMMA_DECODE_SLOTS
    dcases = [("gemma2 decode, local layer", B_, L_, g2, bf, win, cap, scale,
               True, False),
              ("gemma2 decode, global layer", B_, L_, g2, bf, 0, cap, scale,
               True, False),
              ("gemma2 decode, local layer, softcap biting", B_, L_, g2, bf,
               win, cap, scale, False, True),
              ("gemma2 decode f32", 4, L_, g2, f32, win, cap, scale, False,
               False),
              ("gemma2 decode f32, softcap biting", 4, L_, g2, f32, win, cap,
               scale, False, True),
              ("qwen2.5-14b smoke, D 12 padded", 64, 256, qs, f32, 0, 0.0,
               None, False, False)]
    for label, B, L, c, dt, w, sc, scl, timed, bite in dcases:
        if timed:
            # a generator of the case's own: every run times these lengths
            q, k, v, lengths = decode_case(
                B, L, c.n_heads, c.n_kv_heads, c.d_head, w, dev,
                GEMMA_MAX_PROMPT + GEMMA_DECODE_STEPS)
        else:
            q, k, v = decode_inputs(B, L, c.n_heads, c.n_kv_heads, c.d_head,
                                    dt, gen, dev)
            lengths = torch.randint(1, min(L, GEMMA_MAX_PROMPT
                                           + GEMMA_DECODE_STEPS) + 1, (B,),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
            lengths[:3] = torch.tensor([1, min(L, GEMMA_MAX_PROMPT
                                               + GEMMA_DECODE_STEPS),
                                        max(w, 1)], device=dev)
        if bite:
            q = (q.float() * BITE_Q).to(dt)
        atol = BF16_ATOL if dt == bf else F32_ATOL
        got = flash_decode(q, k, v, lengths, window=w, softcap=sc,
                           sm_scale=scl)
        want = flash_decode_ref(q, k, v, lengths, window=w, softcap=sc,
                                sm_scale=scl)
        torch.cuda.synchronize()
        err = max_err(got, want)
        if got.shape != q.shape or not torch.isfinite(got).all() \
                or err > atol:
            raise AssertionError(f"flash_decode {label}: max abs err {err} "
                                 f"> {atol}")
        worst_dec = max(worst_dec, err) if dt == bf else worst_dec
        row = {"shape": f"{label}: B={B} L={L} {c.n_heads}/{c.n_kv_heads} "
                        f"heads D={c.d_head} {dt} window={w} softcap={sc}",
               "max_abs_err": err}
        msg = f"flash_decode {row['shape']}: max abs err {err:.3e}"
        if bite:
            row["softcap_moves_plain"] = softcap_moves(
                lambda **kw_: flash_decode_ref(q, k, v, lengths, **kw_),
                dict(window=w, softcap=sc, sm_scale=scl), atol,
                f"flash_decode {label}")
            msg += (f"; the softcap moves the plain output by "
                    f"{row['softcap_moves_plain']:.3e}")
        row["instance"] = FD.instance(c.n_heads // c.n_kv_heads,
                                      max(c.d_head, FA.MIN_HEAD_DIM), dt)
        if timed:
            t = decode_timing(q, k, v, lengths, flush, plain_iters=5,
                              window=w, softcap=sc, scale=scl)
            row.update({key: t[key] for key in ("ms", "plain_ms",
                                                "library_ms", "bound_ms",
                                                "bound_by", "mean_length")})
            row["library"] = "sdpa with a mask, no softcap"
            kw = dict(window=w, softcap=sc, sm_scale=scl)
            row["pieces_ms"] = timed_ms(lambda: flash_decode(
                q, k, v, lengths, kernel="pieces", **kw), 200, flush)
            row["share"] = t["bound_ms"] / t["ms"]
            row["pieces_share"] = t["bound_ms"] / row["pieces_ms"]
            if row["instance"] != "tma" or t["ms"] >= row["pieces_ms"]:
                raise AssertionError(f"flash_decode {label}: the "
                                     f"{row['instance']} instance "
                                     f"{t['ms']} ms, not faster than the "
                                     f"pieces kernel's {row['pieces_ms']} "
                                     f"ms")
            row["checks"] = tma_decode_checks(q, k, v, lengths, kw, label)
            msg += (f"; mean valid length {t['mean_length']:.1f}: the "
                    f"{row['instance']} instance {t['ms']:.4f} ms "
                    f"({row['share']:.3f} of the bound), the pieces kernel "
                    f"{row['pieces_ms']:.4f} ms ({row['pieces_share']:.3f}), "
                    f"plain {t['plain_ms']:.4f} ms, {row['library']} "
                    f"{t['library_ms']:.4f} ms (vs plain without softcap: "
                    f"{t['library_err']:.3e}), bound {t['bound_ms']:.6f} ms "
                    f"({t['bound_by']}: {t['bytes']} B, {t['flops']} FLOP); "
                    f"{json.dumps(row['checks'])}")
        log(msg)
        decode.append(row)
        del q, k, v, got, want
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": (attn, worst_attn),
            "flash_decode": (decode, worst_dec),
            "flash_attention_bwd": (bwd, worst_bwd)}


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    return tree.cpu().numpy()


def phase_smoke_evaluators(dev) -> None:
    """Each new evaluator at smoke width (float32; flash_attention at D
    16, and D 12 padded to 16) on the card against the same weights on
    the CPU, trust within F32_ATOL; then the serve launcher as a user
    runs it (``--sync --arch <id> --corpus 192 --drain-mode fused``) on
    the card for each, exiting 0 with a response per request."""
    from repro_torch.models import gnn as gnn_model
    worst = {}
    for arch in NEW_ARCHS:
        cfg = get_config(arch, smoke=True)
        model = gnn_model if arch == "gcn-cora" else T
        params = numpy_tree(model.init_params(
            cfg, torch.Generator().manual_seed(SEED)))
        ev_c, mk = make_evaluator(arch, smoke=True, params=params,
                                  device="cpu")
        ev_g, _ = make_evaluator(arch, smoke=True, params=params, device=dev)
        feats = mk(256, fseed=3)
        want = ev_c({k: torch.from_numpy(v) for k, v in feats.items()})
        got = ev_g({k: torch.as_tensor(v, device=dev)
                    for k, v in feats.items()}).cpu()
        worst[arch] = max_err(got, want)
        if worst[arch] > F32_ATOL or not torch.isfinite(got).all():
            raise AssertionError(f"{arch} smoke on the card vs the CPU: "
                                 f"{worst[arch]} > {F32_ATOL}")
    log(f"smoke-width evaluators on the card vs the CPU (256 items, same "
        f"weights): max |trust diff| {json.dumps(worst)} <= {F32_ATOL}")
    for arch in NEW_ARCHS:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main(["--sync", "--arch", arch, "--corpus", "192",
                             "--n-requests", "3", "--drain-mode", "fused",
                             "--device", str(dev)])
        lines = out.getvalue().splitlines()
        if rc != 0 or not lines[0].startswith(f"{arch} on {dev}:") \
                or sum(l.lstrip().startswith("req ") for l in lines) != 3 \
                or not lines[-1].startswith("P50 "):
            raise AssertionError(f"serve --arch {arch}: rc {rc}, output "
                                 f"{lines}")
        log(f"serve --sync --arch {arch}: {lines[0]} ... {lines[-1]}")


def phase_gemma2_engine(cfg: TrustIRConfig, corpus, shard, dev) -> dict:
    """gemma2-2b at full width and depth on the main path: 384 queries
    through ``ServingEngine`` (fused, depth 2) on the 65536-document
    shard, then the host-vs-fused engine parity run and one profiled
    fused step."""
    full = get_config(GEMMA)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    evaluate, mk = make_evaluator(GEMMA, smoke=False, seed=SEED, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    log(f"{GEMMA}: {full.n_layers} layers, d_model {full.d_model}, "
        f"{full.n_heads}/{full.n_kv_heads} heads of {full.d_head}, vocab "
        f"{full.vocab_size}, windows {T.layer_windows(full)[:2]}..., "
        f"softcaps {full.attn_logit_softcap}/{full.final_logit_softcap}: "
        f"evaluator built on the card in {time.monotonic() - t0:.1f} s, "
        f"{held / 1e9:.2f} GB of bf16 weights")

    def doc_features(docs):
        return mk(len(docs), fseed=int(docs[0]) % 1_000_000
                  if len(docs) else 0)

    def make_searcher():
        return CorpusSearcher(corpus, [shard], feature_fn=doc_features)

    def expect(n_searches, n_batches):
        return {"topk_select": n_searches, "shed_partition": n_batches,
                "flash_attention": full.n_layers * n_batches,
                "dot_interaction": 0, "flash_decode": 0, **NO_BACKWARD,
                "score_head": (HEAD_INSTANCE[GEMMA] == "fused") * n_batches}

    stats = phase_engine(cfg, make_searcher(), evaluate, dev,
                         f"{GEMMA} engine", expect)
    stats["peak_bytes"] = torch.cuda.max_memory_allocated()
    phase_engine_parity(cfg, make_searcher, evaluate, dev, f"{GEMMA} engine",
                        TRUST_ATOL)
    fused = FusedLoadShedder(cfg, evaluate, device=dev)
    batches = [(np.arange(off, off + ENGINE_BATCH, dtype=np.uint32),
                np.zeros(ENGINE_BATCH, np.int32), mk(ENGINE_BATCH, fseed=off))
               for off in (500_001, 600_001)]
    fused.process(*batches[0])
    stats["profile"] = device_profile(
        f"one fused {GEMMA} step, {ENGINE_BATCH} items",
        lambda: fused.process(*batches[1]))
    stats["weights_bytes"] = held
    log(f"{GEMMA} engine: peak device memory of the measured run "
        f"{stats['peak_bytes'] / 2 ** 30:.2f} GiB")
    return stats


def phase_gemma2_decode(dev) -> dict:
    """16 seeded prompts of 1..8000 tokens, one ``prefill`` each at B 1,
    admitted into a 16-slot ``KVCachePool`` of 8192 positions; 16
    ``decode_step``s over the pool, the local layers' 4096-key window and
    both softcaps in play; decode logits of a few slots at a few steps
    held against the full forward's last position."""
    cfg = get_config(GEMMA)
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), device=dev, dtype=L.dtype_of(cfg.dtype))
    r = np.random.default_rng(SEED + 19)
    prompt_lens = r.integers(1, GEMMA_MAX_PROMPT + 1,
                             size=GEMMA_DECODE_SLOTS)
    prompt_lens[:3] = (1, GEMMA_MAX_PROMPT, cfg.sliding_window + 1)
    prompts = [r.integers(0, cfg.vocab_size, size=n) for n in prompt_lens]
    feed = r.integers(0, cfg.vocab_size,
                      size=(GEMMA_DECODE_STEPS, GEMMA_DECODE_SLOTS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = KVCachePool(cfg, n_slots=GEMMA_DECODE_SLOTS,
                       max_len=GEMMA_MAX_LEN, device=dev)
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (pool.cache["k"], pool.cache["v"]))
    reset_launches()
    t0 = time.monotonic()
    scores = []
    for i, p in enumerate(prompts):
        score, kv = T.prefill(params, cfg, torch.as_tensor(
            p, dtype=torch.int32, device=dev)[None])
        if pool.admit(i, kv, prompt_len=len(p)) != i:
            raise AssertionError(f"prompt {i} did not get slot {i}")
        scores.append(score)
        del kv
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    prefill_launches = {n: w.launches for n, w in KERNELS.items()}
    scores = torch.cat(scores)
    if prefill_launches["flash_attention"] != cfg.n_layers \
            * GEMMA_DECODE_SLOTS or prefill_launches["score_head"] \
            or not torch.isfinite(scores).all():
        raise AssertionError(f"{GEMMA} prefill: launches {prefill_launches}"
                             f", finite scores "
                             f"{bool(torch.isfinite(scores).all())}")
    check_slots = (0, 1, 2)                # 1, 8000 and 4097 tokens
    check_steps = (0, GEMMA_DECODE_STEPS // 2, GEMMA_DECODE_STEPS - 1)
    kept = {}
    reset_launches()
    t1 = time.monotonic()
    for t in range(GEMMA_DECODE_STEPS):
        tok = torch.as_tensor(feed[t], dtype=torch.int32, device=dev)
        logits, pool.cache = T.decode_step(params, cfg, tok, pool.cache)
        if t in check_steps:
            kept[t] = logits[list(check_slots)].float().clone()
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t1
    launches = {n: w.launches for n, w in KERNELS.items()}
    want = {n: 0 for n in KERNELS}
    want["flash_decode"] = cfg.n_layers * GEMMA_DECODE_STEPS
    if launches != want:
        raise AssertionError(f"{GEMMA} decode: launches {launches}, "
                             f"expected {want}")
    by_instance = dict(flash_decode.by_instance)
    if by_instance != {"tma": want["flash_decode"], "pieces": 0}:
        raise AssertionError(f"{GEMMA} decode: flash_decode launches by "
                             f"instance {by_instance}, expected all on tma")
    lengths = pool.cache["lengths"].cpu().numpy()
    if not np.array_equal(lengths, prompt_lens + GEMMA_DECODE_STEPS):
        raise AssertionError("decode: cache lengths do not count the steps")
    peak = torch.cuda.max_memory_allocated()
    extra = torch.as_tensor(feed[0], dtype=torch.int32, device=dev)

    def one_step():
        _, pool.cache = T.decode_step(params, cfg, extra, pool.cache)

    profile = device_profile(f"one {GEMMA} decode_step, "
                             f"{GEMMA_DECODE_SLOTS} slots", one_step)
    worst, worst_rel = 0.0, 0.0
    for slot in check_slots:
        for t in check_steps:
            toks = np.concatenate([prompts[slot], feed[:t + 1, slot]])
            with torch.no_grad():
                x = T.hidden_states(params, cfg, torch.as_tensor(
                    toks, dtype=torch.int32, device=dev)[None])
                full = T.unembed(params, cfg, x[:, -1])[0].float()
            diff = (kept[t][check_slots.index(slot)] - full).abs()
            worst = max(worst, float(diff.max()))
            worst_rel = max(worst_rel, float(diff.norm() / full.norm()))
    if worst > GEMMA_DECODE_LOGIT_ATOL:
        raise AssertionError(f"{GEMMA} decode logits differ from the "
                             f"forward by {worst} > "
                             f"{GEMMA_DECODE_LOGIT_ATOL}")
    for slot in range(GEMMA_DECODE_SLOTS):
        pool.retire(slot)
    past = int((prompt_lens + GEMMA_DECODE_STEPS > cfg.sliding_window).sum())
    n_tokens = GEMMA_DECODE_SLOTS * GEMMA_DECODE_STEPS
    stats = {"prefill_s": prefill_s, "decode_s": decode_s,
             "tokens_per_s": n_tokens / decode_s,
             "step_ms": decode_s / GEMMA_DECODE_STEPS * 1e3,
             "launches": launches, "prefill_launches": prefill_launches,
             "by_instance": by_instance, "peak_bytes": peak,
             "logit_err": worst, "profile": profile}
    log(f"{GEMMA} decode: {GEMMA_DECODE_SLOTS} prompts of 1.."
        f"{GEMMA_MAX_PROMPT} tokens (mean {prompt_lens.mean():.0f}; "
        f"{past} rows past the {cfg.sliding_window}-key window) prefilled in "
        f"{prefill_s:.2f} s ({prefill_launches['flash_attention']} "
        f"flash_attention launches) into a KVCachePool of "
        f"{GEMMA_DECODE_SLOTS} x {GEMMA_MAX_LEN} ({kv_bytes / 1e9:.2f} GB "
        f"bf16)")
    log(f"{GEMMA} decode: {GEMMA_DECODE_STEPS} decode_steps in "
        f"{decode_s:.3f} s = {stats['tokens_per_s']:.1f} tokens/s, "
        f"{stats['step_ms']:.2f} ms per step; launches {launches} "
        f"(flash_decode by instance {by_instance}); logits "
        f"vs the full forward at slots {check_slots}, steps {check_steps}: "
        f"max abs err {worst:.3e} <= {GEMMA_DECODE_LOGIT_ATOL} (relative "
        f"{worst_rel:.3e}); every slot retired; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB")
    return stats


def f32_tree(tree):
    if isinstance(tree, dict):
        return {k: f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [f32_tree(v) for v in tree]
    return tree.to(torch.float32)


def moe_plain_routing(p, x, mcfg):
    """The plain MoE's routing of x (T, D): the router in float32 over every
    token of the call, each expert taking its first ``capacity`` (token,
    choice) pairs in token order, counted with a running sum of one-hot
    choices (not the port's sort). Returns (weights (T, K), experts (T, K),
    kept (T, K))."""
    T_, _ = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
    w, idx = torch.topk(probs, K, dim=-1)
    if mcfg.norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    c = math.ceil(mcfg.capacity_factor * K * T_ / E)
    cap = max(8, (c + 7) // 8 * 8)
    flat = idx.reshape(-1)
    place = F.one_hot(flat, E).to(torch.int32).cumsum(0, dtype=torch.int32)
    kept = (place.gather(1, flat[:, None])[:, 0] <= cap).reshape(T_, K)
    return w, idx, kept


def moe_plain_rows(p, x, routing, act: str, rows) -> torch.Tensor:
    """The plain MoE's output at the tokens ``rows``: each kept choice's
    expert GLU, weighted, and the shared experts, all in float32 from the
    same weights."""
    w, idx, kept = routing
    xr = x[rows].float()
    out = torch.zeros_like(xr)
    for j, (ks, es, ws) in enumerate(zip(kept[rows].tolist(),
                                         idx[rows].tolist(), w[rows])):
        for k_ok, e, wt in zip(ks, es, ws):
            if k_ok:
                h = L.glu(xr[j] @ p["w_gate"][e].float(),
                          xr[j] @ p["w_up"][e].float(), act)
                out[j] += wt * (h @ p["w_down"][e].float())
    if "shared" in p:
        out += L.glu_ffn_apply(f32_tree(p["shared"]), xr, act=act)
    return out


def check_moe_layer(arch: str, params, full, tokens, label: str,
                    must_drop: bool) -> dict:
    """The first MoE layer of the full-width bf16 evaluator on one
    evaluator call's tokens (``tokens`` (rows, DOC_LEN), of which the
    trunk sees the first 31 positions; capacity counts every token of the
    call), normed as the layer sees its input: ``moe_apply`` against the
    plain MoE at MOE_CHECK_ROWS tokens, half of them with a dropped
    choice and half spread over the call. The dropped fractions must be
    equal and the outputs within MOE_REL_TOL (norm of the difference over
    the norm of the plain); with ``must_drop`` some choice must have been
    dropped."""
    bp = params["blocks"][0]
    dev = bp["ln2"]["scale"].device
    toks = torch.from_numpy(tokens[:, :-1]).to(dev)
    x = L.rmsnorm_apply(bp["ln2"], L.embed_apply(params["embed"], toks,
                                                 torch.bfloat16),
                        full.norm_eps).reshape(-1, full.d_model)
    got, metrics = M.moe_apply(bp["moe"], x, full.moe, act=full.act,
                               compute_dtype=torch.bfloat16)
    routing = moe_plain_routing(bp["moe"], x, full.moe)
    kept = routing[2]
    T_, K = kept.shape
    frac = 1.0 - kept.sum() / (T_ * K)
    half = MOE_CHECK_ROWS // 2
    with_drop = (~kept).any(dim=1).nonzero()[:, 0]
    with_drop = with_drop[torch.linspace(0, len(with_drop) - 1, half,
                                         device=dev).long()] \
        if len(with_drop) else with_drop
    spread = torch.linspace(0, T_ - 1, MOE_CHECK_ROWS - len(with_drop),
                            device=dev).long()
    rows = torch.unique(torch.cat([with_drop, spread]))
    want = moe_plain_rows(bp["moe"], x, routing, full.act, rows)
    diff = got[rows].float() - want
    rel = float(diff.norm() / want.norm())
    err = float(diff.abs().max())
    port_frac = float(metrics["moe_drop_frac"])
    stats = {"tokens": T_, "rows": len(rows), "rows_with_drop":
             len(with_drop), "drop_frac": float(frac),
             "port_drop_frac": port_frac, "rel_err": rel,
             "max_abs_err": err, "ref_max_abs": float(want.abs().max())}
    log(f"{arch}: first MoE layer at full width on one evaluator call of "
        f"{label} ({T_} tokens, {full.moe.n_experts} experts, top {K}): moe_apply "
        f"bf16 vs plain f32 at {len(rows)} tokens ({len(with_drop)} with a "
        f"dropped choice): rel err {rel:.3e}, max abs err {err:.3e} (plain "
        f"max |out| {stats['ref_max_abs']:.3e}); dropped fraction "
        f"{port_frac} (plain {float(frac)})")
    if abs(port_frac - float(frac)) > 0.5 / (T_ * K) or not rel <= \
            MOE_REL_TOL or not torch.isfinite(got).all() \
            or (must_drop and not len(with_drop)):
        raise AssertionError(f"{arch}: moe_apply vs plain: {stats}")
    return stats


def score_f32_by_layer(params, cfg, tokens: torch.Tensor,
                       trust_scale: float) -> torch.Tensor:
    """The transformer evaluator's trust of ``tokens`` computed in float32
    from the same bf16 weights, each layer upcast as it runs (a float32
    copy of the whole model would not fit beside it)."""
    f32 = torch.float32
    c32 = dataclasses.replace(cfg, dtype="float32")
    B, S = tokens.shape[0], tokens.shape[1] - 1
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    head = f32_tree({k: params[k] for k in ("embed", "unembed")
                     if k in params})
    x = T._embed(head, c32, tokens[:, :-1], f32)
    for bp, w in zip(T._layers(params), T.layer_windows(cfg)):
        x = T._block_fwd(f32_tree(bp), c32, x, pos, w, f32, DOC_LEN)[0]
    x = L.rmsnorm_apply(f32_tree(params["final_norm"]), x, cfg.norm_eps)
    lp = T._mean_token_logprob(head, c32, x, tokens[:, 1:],
                               T._token_chunk(c32))
    return torch.sigmoid(lp + math.log(cfg.vocab_size)) * trust_scale


def check_dense_scores(arch: str, evaluate, full, tokens,
                       trust_scale: float) -> dict:
    """DENSE_CHECK_ITEMS documents scored by the full-width bf16
    evaluator against the same weights in float32, layer by layer: the
    q/k/v biases, the untied unembed and every other part of the block at
    published width. Within DENSE_TRUST_ATOL."""
    dev = evaluate.params["final_norm"]["scale"].device
    toks = torch.from_numpy(tokens[:DENSE_CHECK_ITEMS]).to(dev)
    got = evaluate({"tokens": toks})
    want = score_f32_by_layer(evaluate.params, full, toks, trust_scale)
    err = float((got.float() - want).abs().max())
    log(f"{arch}: {len(toks)} documents, bf16 evaluator vs the same weights "
        f"in float32 layer by layer: max |trust diff| {err:.3e} (trust "
        f"{float(want.min()):.4f}..{float(want.max()):.4f})")
    if not err <= DENSE_TRUST_ATOL:
        raise AssertionError(f"{arch}: bf16 vs float32 trust {err} > "
                             f"{DENSE_TRUST_ATOL}")
    return {"items": len(toks), "max_abs_err": err}


def phase_big_evaluator(arch: str, max_evals: int, dev) -> dict:
    """One evaluator at its published width and depth, seeded weights
    built on the card, served by ``phase_serving`` (``TrustIRConfig()``,
    ``DrainExecutor`` depth 2, BIG_BATCHES micro-batches after a warm-up,
    ``max_evals`` evaluator rows a batch, 0 = all); then one profiled
    fused step, and the full-width check of the model: its first MoE layer
    against a plain float32 MoE, or a dense model's scores against the
    same weights in float32."""
    cfg = TrustIRConfig()
    full = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    evaluate, mk = make_evaluator(arch, smoke=False, seed=SEED, device=dev,
                                  trust_scale=cfg.trust_scale)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    build_s = time.monotonic() - t0
    n_attn = full.n_layers if hasattr(full, "n_heads") else 0
    n_head = int(HEAD_INSTANCE.get(arch) == "fused")
    stats, fused = phase_serving(cfg, evaluate, mk, dev, label=arch,
                                 n_attn=n_attn, n_head=n_head,
                                 n_batches=BIG_BATCHES,
                                 max_evals=max_evals, seed=SEED + 23,
                                 fseed=3000, probe_sync=False, warm_up=True)
    _, keys, buckets, feats, n = drain_batches(mk, 1, SEED + 24, 3100)[0]
    profile = device_profile(f"one fused {arch} step",
                             lambda: fused.process(keys, buckets, feats,
                                                   n_valid=n))
    peak = torch.cuda.max_memory_allocated()
    del fused
    if getattr(full, "moe", None) is not None:
        rows = max_evals or BATCH
        # the drain's own documents (uniform tokens route evenly: nothing
        # overflows at capacity factor 1.25), then Zipf-skewed tokens,
        # whose hottest experts overflow, so that drops are held too
        zipf = np.minimum(np.random.default_rng(SEED + 25).zipf(
            MOE_ZIPF_A, size=(rows, DOC_LEN)), full.vocab_size) - 1
        stats["moe_check"] = [
            check_moe_layer(arch, evaluate.params, full,
                            feats["tokens"][:rows], "the drain's documents",
                            must_drop=False),
            check_moe_layer(arch, evaluate.params, full,
                            zipf.astype(np.int32), f"Zipf({MOE_ZIPF_A}) "
                            f"tokens", must_drop=True)]
    elif n_attn:
        stats["dense_check"] = check_dense_scores(arch, evaluate, full,
                                                  feats["tokens"],
                                                  cfg.trust_scale)
    if getattr(full, "moe", None) is not None:
        stats["sharded"] = moe_sharded_check(arch, evaluate, mk, full,
                                             max_evals, zipf, dev)
    stats.update({"weights_bytes": held, "peak_bytes": peak,
                  "build_s": build_s, "profile": profile})
    share = f"{profile['busy_share']:.3f}" if profile else "not measured"
    log(f"{arch}: weights {held / 1e9:.2f} GB built on the card in "
        f"{build_s:.1f} s; device busy share of one step {share}; peak "
        f"device memory while serving {peak / 2 ** 30:.2f} GiB, with the "
        f"check {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    return stats


def moe_sharded_check(arch: str, evaluate, mk, full, max_evals: int,
                      zipf: np.ndarray, dev) -> dict:
    """The sharded MoE evaluator on this card's (1, 1) mesh (a world of
    one): ``make_sharded_evaluator`` over the replicated evaluator's own
    weights (no second set), its experts placed by the EP rule and its
    forward taking ``moe_apply_ep``. The same SHARDED_MOE_BATCHES
    fused-drain batches on SimClocks through both, with the same
    ``max_evals``: regimes, tiers and counts equal, trust within
    TRUST_ATOL; the sharded run's launches are the path's. Then the first
    MoE layer on one call of the Zipf-skewed tokens ``zipf`` (whose
    hottest experts overflow): the dispatch's keep set on the card equals
    the same plan's on the CPU and ``moe_apply``'s dropped fraction, some
    choice is dropped, and ``moe_apply_ep``'s output equals
    ``moe_apply``'s bit for bit."""
    from repro_torch.distribution.constraints import use_mesh
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    from repro_torch.serving.evaluators import make_sharded_evaluator
    cfg = TrustIRConfig()
    rate = float(cfg.u_capacity) / cfg.deadline_s
    mesh = make_host_mesh((1, 1))
    try:
        se = make_sharded_evaluator(arch, mesh=mesh, params=evaluate.params)
        batches = drain_batches(mk, SHARDED_MOE_BATCHES, SEED + 26, 3200)
        runs, launches = {}, None
        for name, ev in (("replicated", evaluate), ("sharded", se.evaluate)):
            fused = FusedLoadShedder(cfg, ev, max_evals=max_evals or None,
                                     device=dev, sim_clock=SimClock(rate))
            torch.cuda.synchronize()
            reset_launches()
            runs[name] = [fused.process(keys, b, feats, n_valid=n)
                          for _, keys, b, feats, n in batches]
            torch.cuda.synchronize()
            launches = read_launches()
            note_instances(f"{arch} {name}")
            del fused
        worst = 0.0
        for a, b in zip(runs["replicated"], runs["sharded"]):
            counts = [(r.n_evaluated, r.n_cached, r.n_prior, r.uload)
                      for r in (a, b)]
            if a.regime != b.regime or not np.array_equal(a.tier, b.tier) \
                    or counts[0] != counts[1]:
                raise AssertionError(f"{arch} sharded: regime {a.regime}/"
                                     f"{b.regime}, counts {counts}")
            worst = max(worst, float(np.abs(a.trust - b.trust).max()))
        want = {n: 0 for n in KERNELS}
        want["shed_partition"] = SHARDED_MOE_BATCHES
        want["flash_attention"] = full.n_layers * SHARDED_MOE_BATCHES
        want["score_head"] = (HEAD_INSTANCE[arch] == "fused") \
            * SHARDED_MOE_BATCHES
        if worst > TRUST_ATOL or launches != want:
            raise AssertionError(f"{arch} sharded: max |trust diff| {worst}"
                                 f", launches {launches} (expected {want})")
        # the first MoE layer: keep sets and outputs
        bp = next(b for b in evaluate.params["blocks"] if "moe" in b)
        toks = torch.from_numpy(zipf[:, :-1]).to(dev)
        x = L.rmsnorm_apply(bp["ln2"], L.embed_apply(
            evaluate.params["embed"], toks, torch.bfloat16),
            full.norm_eps).reshape(-1, full.d_model)
        mcfg = full.moe
        with torch.no_grad():
            with use_mesh(mesh):
                ep, _ = M.moe_apply_ep(bp["moe"], x, mcfg, act=full.act)
            ref, metrics = M.moe_apply(bp["moe"], x, mcfg, act=full.act)
        _, _, idx = M._router(bp["moe"], x, mcfg)
        C = M.capacity(x.shape[0], mcfg)
        # the keep set on the card, against the same plan on the CPU
        # (which tests/test_torch_moe_ep.py holds to JAX's keep sets) and
        # against moe_apply's dropped fraction
        keep = M.slot_keep(idx, 0, mcfg.n_experts, C)
        keep_cpu = M.slot_keep(idx.cpu(), 0, mcfg.n_experts, C)
        dropped = int((~keep).sum())
        frac = float(metrics["moe_drop_frac"])
        want = float((1.0 - keep.sum() / idx.numel()).to(torch.float32))
        if not torch.equal(keep.cpu(), keep_cpu) or frac != want \
                or not torch.equal(ep, ref) or not dropped:
            raise AssertionError(f"{arch}: moe_apply_ep vs moe_apply on the "
                                 f"(1, 1) mesh: keep sets equal the CPU's "
                                 f"{torch.equal(keep.cpu(), keep_cpu)}, "
                                 f"{dropped} dropped, moe_drop_frac {frac}, "
                                 f"outputs equal {torch.equal(ep, ref)}")
    finally:
        destroy_world()
    log(f"{arch} sharded (the card's (1, 1) mesh, experts placed by the EP "
        f"rule, moe_apply_ep): {SHARDED_MOE_BATCHES} SimClock fused-drain "
        f"batches (max_evals {max_evals or 'all'}) through the replicated "
        f"and the sharded evaluator: regimes, tiers and counts equal, max "
        f"|trust diff| {worst:.3e} (<= {TRUST_ATOL}); launches {launches}; "
        f"first MoE layer on {x.shape[0]} Zipf({MOE_ZIPF_A}) tokens: keep "
        f"set equal to the CPU's and to moe_drop_frac "
        f"({dropped} of {idx.numel()} choices dropped at capacity {C}), "
        f"moe_apply_ep == moe_apply bit for bit")
    return {"launches": launches, "max_trust_diff": worst,
            "dropped": dropped, "choices": idx.numel(), "capacity": C,
            "regimes": [r.regime.name for r in runs["sharded"]]}


# ---------------------------------------------------------------------------
# phase 16-18: training on the card
# ---------------------------------------------------------------------------

def reset_launches() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    for name in flash_attention.by_instance:
        flash_attention.by_instance[name] = 0
    for name in flash_decode.by_instance:
        flash_decode.by_instance[name] = 0
    for name in SH.score_head.by_instance:
        SH.score_head.by_instance[name] = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in KERNELS.items()}


def check_instances() -> dict:
    """Every path's ``flash_attention`` launches went to the instance the
    rules name for its evaluator: the short one for smollm's and the Qwen
    models' S 31 (the fused drain, the engine, the fleet, the fan-out,
    the sharded engines and the Qwen drains), ``mma.sync`` for gemma2's D
    256. The other paths' splits (the decode run's prefills of S
    1..1984 over the three bf16 instances by length, training on the
    ``wgmma`` one) are recorded. Returns the launches by path and
    instance."""
    qwens = [a for a, _ in BIG_EVALUATORS if a != "gcn-cora"]
    moes = [a for a in qwens if get_config(a).moe is not None]
    want = {path: "short" for path in (
        "serving", "engine", "fleet", "fanout", "replicated", "sharded",
        *qwens, *(f"{a} {n}" for a in moes
                  for n in ("replicated", "sharded")))}
    want[f"{GEMMA} engine"] = "mma.sync"
    for path, name in want.items():
        split = INSTANCES.get(path)
        if not split or set(split) != {name}:
            raise AssertionError(f"flash_attention on path {path}: launches "
                                 f"by instance {split}, expected all on "
                                 f"{name}")
    log(f"flash_attention launches by path and instance: "
        f"{json.dumps(INSTANCES)}")
    return dict(INSTANCES)


def check_head_instances() -> dict:
    """Every path's scoring-head calls took the path ``HEAD_INSTANCE``
    names for its evaluator: the kernel for smollm's paths (the fused
    drain, the engine, the fleet, the fan-out, the sharded engines on
    this card's (1, 1) mesh, whose vocabulary is whole here, and the
    decode run's prefills) and the Qwens' drains and the MoE Qwens'
    sharded checks; the chunked path for gemma2's engine. Returns the
    calls by path and instance."""
    moes = [a for a, _ in BIG_EVALUATORS if a in HEAD_INSTANCE
            and get_config(a).moe is not None]
    want = {path: HEAD_INSTANCE["smollm-135m"] for path in (
        "serving", "engine", "fleet", "fanout", "replicated", "sharded",
        "decode prefill")}
    want.update({a: HEAD_INSTANCE[a] for a, _ in BIG_EVALUATORS
                 if a in HEAD_INSTANCE})
    want.update({f"{a} {n}": HEAD_INSTANCE[a] for a in moes
                 for n in ("replicated", "sharded")})
    want[f"{GEMMA} engine"] = HEAD_INSTANCE[GEMMA]
    for path, name in want.items():
        split = HEAD_INSTANCES.get(path)
        if not split or set(split) != {name}:
            raise AssertionError(f"score_head on path {path}: calls by "
                                 f"instance {split}, expected all on {name}")
    log(f"score_head calls by path and instance: "
        f"{json.dumps(HEAD_INSTANCES)}")
    return dict(HEAD_INSTANCES)


# flash_attention's launches and the scoring head's calls of each path by
# the instance that ran them, read with the launch counts
# (``note_instances``)
INSTANCES: dict = {}
HEAD_INSTANCES: dict = {}


def note_instances(path: str) -> dict:
    """Records and returns the ``flash_attention`` launches since the last
    ``reset_launches`` by instance (the nonzero ones), as path ``path``;
    records the scoring head's calls by instance beside them."""
    INSTANCES[path] = {k: n for k, n in flash_attention.by_instance.items()
                       if n}
    HEAD_INSTANCES[path] = {k: n for k, n in
                            SH.score_head.by_instance.items() if n}
    return INSTANCES[path]


@contextlib.contextmanager
def plain_attention():
    """The model's attention in its plain chunked form on the card, for
    the float32 reference runs of the checks only."""
    saved = A.attention
    A.attention = A.chunked_attention
    try:
        yield
    finally:
        A.attention = saved


def accum_batches(stream, n: int):
    """A stream of global batches as ``n`` stacked microbatches each."""
    for b in stream:
        yield {k: v.reshape(n, -1, *v.shape[1:]) for k, v in b.items()}


def step_timer(times: list):
    """A ``TL.train`` hook that records the wall clock after each step,
    with the card synchronized."""
    def hook(i, state, metrics):
        torch.cuda.synchronize()
        times.append(time.monotonic())
    return hook


def cosines(got: list, want: list) -> list:
    return [float(torch.dot(a.flatten().double(), b.flatten().double())
                  / (a.double().norm() * b.double().norm()).clamp(min=1e-300))
            for a, b in zip(got, want)]


def grads_of(params, loss_fn, batch) -> list:
    """Every leaf's gradient of ``loss_fn(params, batch)`` (detached), the
    leaves' ``.grad`` cleared after."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
        p.grad = None
    loss = loss_fn(params, batch)
    (loss[0] if isinstance(loss, tuple) else loss).backward()
    out = [p.grad for p in flat]
    for p in flat:
        p.grad = None
    return out


def state_leaves(state) -> list:
    return leaves((state.params, state.opt))


def phase_train_lm(dev, run: LMRun) -> dict:
    """``run.arch`` at its published width and depth through the training
    stack on the card (float32 masters, bf16 compute, remat): its checks
    first (step 0's loss and one microbatch's gradient against the
    float32 plain-attention run), then ``run.steps`` steps; with
    ``run.ckpt_step`` an ``AsyncCheckpointer`` save there and a restart
    from that checkpoint through the last steps, which must give the
    straight run's parameters and AdamW moments bit for bit; without, the
    first step run again from the same state (the parameters rebuilt from
    the seed), which must give the same parameters and moments bit for bit
    (the straight run's copied to the host). The launch counts are read
    around the straight run (and the restart)."""
    cfg = get_config(run.arch)
    cfg32 = reduced(cfg, dtype="float32")
    n_glob = run.micro * run.accum
    opt = train_launch.opt_config(run.lr, run.steps)

    def init():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return T.init_params(cfg, gen, device=dev)      # float32 masters

    params0 = init()
    n_params = sum(p.numel() for p in leaves(params0))
    log(f"train: {run.arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.d_head}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e6:.1f}M float32 master weights, "
        f"{cfg.dtype} compute, remat={cfg.remat}); microbatch "
        f"{run.micro} x {TRAIN_SEQ}, grad_accum {run.accum}: "
        f"{n_glob * TRAIN_SEQ} tokens a step; AdamW lr {opt.lr}, warmup "
        f"{opt.warmup_steps}, {opt.total_steps} steps")

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"])

    def loss32(p, b):
        return T.lm_loss(p, cfg32, b["tokens"], b["labels"])

    def batches(start=0):
        return accum_batches(TD.lm_batches(cfg, n_glob, TRAIN_SEQ, seed=1,
                                           start_step=start), run.accum)

    first = TL.to_device(next(TD.lm_batches(cfg, n_glob, TRAIN_SEQ, seed=1)),
                         dev)
    micro = [{k: v[i * run.micro:(i + 1) * run.micro]
              for k, v in first.items()} for i in range(run.accum)]
    t0 = time.monotonic()
    with torch.no_grad(), plain_attention():
        loss0_32 = float(sum(loss32(params0, mb)[0] for mb in micro)
                         / run.accum)
    g_bf = grads_of(tree_map(lambda t: t.detach().clone(), params0),
                    loss_fn, micro[0])
    with plain_attention():
        g_32 = grads_of(tree_map(lambda t: t.detach().clone(), params0),
                        loss32, micro[0])
    cos = cosines(g_bf, g_32)
    n_bf = float(torch.sqrt(sum(g.double().square().sum() for g in g_bf)))
    n_32 = float(torch.sqrt(sum(g.double().square().sum() for g in g_32)))
    worst = int(np.argmin(cos))
    paths = [p for p, _ in leaves_with_paths(params0)]
    log(f"train ({run.arch}): one microbatch's gradient, bf16 through both "
        f"attention kernels vs float32 with the plain attention: cosine "
        f"per leaf min {cos[worst]:.6f} ({paths[worst]}), median "
        f"{float(np.median(cos)):.6f} (>= {TRAIN_GRAD_COS}); global norms "
        f"{n_bf:.6f} vs {n_32:.6f} (rel {abs(n_bf - n_32) / n_32:.3e} <= "
        f"{TRAIN_NORM_RTOL}); checks {time.monotonic() - t0:.1f} s")
    if min(cos) < TRAIN_GRAD_COS or abs(n_bf - n_32) > TRAIN_NORM_RTOL * n_32:
        raise AssertionError(f"train ({run.arch}): gradient cosines {cos} / "
                             f"norms {n_bf} vs {n_32}")
    del g_bf, g_32, micro, first

    step_fn = TL.make_train_step(loss_fn, opt, grad_accum=run.accum)
    with contextlib.ExitStack() as stack:
        ck = None
        if run.ckpt_step:
            ckdir = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="chip_smoke_ckpt_"))
            ck = CK.AsyncCheckpointer(ckdir)
            state = TL.init_state(tree_map(lambda t: t.detach().clone(),
                                           params0))
        else:
            del params0                  # rebuilt from the seed below
            state = TL.init_state(init())
        first_step = []                  # the state after step 0, on the host

        def keep_first(i, st, metrics):
            if not run.ckpt_step and i == 0:
                first_step.extend(t.detach().to("cpu", copy=True)
                                  for t in state_leaves(st))
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.monotonic()
        straight, hist = TL.train(
            state, step_fn, batches(), run.steps, log_every=1,
            checkpointer=ck, ckpt_every=run.ckpt_step,
            hooks=(keep_first, step_timer(times)))
        peak = torch.cuda.max_memory_allocated()
        walls = np.diff([t0] + times)
        del state                        # its tensors were updated in place
        if run.ckpt_step:
            fresh = TL.init_state(tree_map(torch.zeros_like, params0))
            restored, extra = CK.restore(ckdir, fresh, step=run.ckpt_step)
            again, hist2 = TL.train(
                restored, step_fn, batches(run.ckpt_step),
                run.steps - run.ckpt_step, log_every=1,
                start_step=run.ckpt_step)
            del fresh, restored
        torch.cuda.synchronize()
        launches = read_launches()
    losses = [h["loss"] for h in hist]
    lrs = " ".join(f"{h['lr']:.2e}" for h in hist)
    norms = " ".join(f"{h['grad_norm']:.3f}" for h in hist)
    log(f"train ({run.arch}): {run.steps} steps, loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}, lr {lrs}, grad_norm "
        f"{norms}; the f32 plain run's step-0 loss {loss0_32:.6f} (|diff| "
        f"{abs(losses[0] - loss0_32):.3e} <= {TRAIN_LOSS_ATOL})")
    if abs(losses[0] - loss0_32) > TRAIN_LOSS_ATOL or not \
            losses[-1] < losses[0] or not np.isfinite(losses).all():
        raise AssertionError(f"train ({run.arch}): losses {losses}, f32 step "
                             f"0 {loss0_32}")
    if run.ckpt_step:
        same = all(torch.equal(a, b) for a, b in zip(state_leaves(again),
                                                     state_leaves(straight)))
        restart_losses = [h["loss"] for h in hist2]
        log(f"train: restart from the step-{extra['step']} checkpoint: "
            f"losses {' '.join(f'{x:.4f}' for x in restart_losses)}; params "
            f"and AdamW moments "
            f"{'equal the straight run bit for bit' if same else 'DIFFER'}")
        if not same or restart_losses != losses[run.ckpt_step:]:
            bad = [p for (p, a), b in zip(
                leaves_with_paths((again.params, again.opt)),
                state_leaves(straight)) if not torch.equal(a, b)]
            raise AssertionError(f"train: the restart differs at {bad[:8]} "
                                 f"({len(bad)} leaves); losses "
                                 f"{restart_losses} vs "
                                 f"{losses[run.ckpt_step:]}")
        n_micro = run.accum * (run.steps + run.steps - run.ckpt_step)
    else:
        # the first step again from the same state: parameters from the
        # seed, zero moments, the same batch
        del straight
        gc.collect()
        torch.cuda.empty_cache()
        again, _ = step_fn(TL.init_state(init()), next(batches()))
        got = state_leaves(again)
        bad = [i for i, (a, b) in enumerate(zip(got, first_step))
               if not torch.equal(a, b.to(dev))]
        log(f"train ({run.arch}): the first step run again from the same "
            f"state: {len(got)} leaves of params and AdamW moments "
            f"{'equal the first run bit for bit' if not bad else 'DIFFER'}")
        if bad or len(got) != len(first_step):
            raise AssertionError(f"train ({run.arch}): the repeated step "
                                 f"differs at leaves {bad[:8]} ({len(bad)})")
        del first_step
        straight = again
        n_micro = run.accum * run.steps
    want = {n: 0 for n in KERNELS}
    want["flash_attention"] = cfg.n_layers * n_micro * (2 if cfg.remat else 1)
    want["flash_attention_bwd"] = cfg.n_layers * n_micro
    if launches != want:
        raise AssertionError(f"train ({run.arch}): launches {launches}, "
                             f"expected {want}")
    tokens = n_glob * TRAIN_SEQ
    # the steady step leaves out step 0 (warm-up, and the host copy of the
    # state where the repeat check takes one) and the steps that end with
    # a checkpoint save (a synchronous copy of params, m and v to the host
    # before the write goes to its thread)
    saves = [i for i in range(run.steps)
             if run.ckpt_step and (i + 1) % run.ckpt_step == 0]
    steady = [w for i, w in enumerate(walls) if i > 0 and i not in saves]
    step_s = float(np.mean(steady))
    save_s = (float(np.mean([walls[i] for i in saves])) - step_s
              if saves else None)
    log(f"train ({run.arch}; {card_line()}): step wall "
        f"{' '.join(f'{w:.3f}' for w in walls)} s"
        + (f" (steps {[i + 1 for i in saves]} end with a checkpoint save)"
           if saves else "")
        + f"; steady (neither step 1 nor a saving step) {step_s:.3f} s = "
        f"{tokens / step_s:.1f} tokens/s"
        + (f"; a save adds {save_s:.3f} s" if saves else "")
        + f"; peak device memory {peak / 2 ** 30:.2f} GiB; launches "
        f"{launches} == {want} ({cfg.n_layers} layers x {n_micro} "
        f"microbatches, the forward twice under remat)")
    # one profiled step (smollm's three read within 0.4% of each other on
    # an H100, at ~30 s each)
    prof = device_profile(f"one {run.arch} training step, {tokens} tokens",
                          lambda: step_fn(straight, next(batches(run.steps))))
    if prof:
        log(f"train ({run.arch}): the profiled step's device busy time "
            f"over the unprofiled steady step "
            f"{prof['busy_ms'] / (step_s * 1e3):.3f}; the attention "
            f"backward's share of the busy time "
            f"{prof['groups_ms']['flash_attention backward kernels'] / prof['busy_ms']:.3f}")
    grads = tree_map(torch.ones_like, straight.params)
    opt_ms = timed_ms(lambda: O.adamw_update(grads, straight.opt,
                                             straight.params, opt), 3)
    log(f"train ({run.arch}): the AdamW update alone (inside the "
        f"elementwise group above): {opt_ms:.3f} ms")
    del straight, again, grads
    return {"arch": run.arch, "launches": launches, "step_s": step_s,
            "save_s": save_s, "tokens_per_s": tokens / step_s,
            "peak_bytes": peak, "losses": losses, "loss0_f32": loss0_32,
            "min_cos": min(cos), "profile": prof, "adamw_ms": opt_ms}


def phase_train_dlrm(dev) -> dict:
    """dlrm-mlperf at its published widths, tables capped at
    DLRM_TRAIN_ROW_CAP rows, trained on the reference's train_batch
    (DLRM_TRAIN_BATCH) from ``recsys_batches``: one step's gradient
    against the float32 run with ``dot_interaction_ref`` on the card
    (cosine per leaf), then DLRM_TRAIN_STEPS steps whose loss must fall,
    each launching both ``dot_interaction`` kernels once."""
    full = get_config("dlrm-mlperf")
    cfg = cap_table_rows(full, DLRM_TRAIN_ROW_CAP)
    rows = sum(E.padded_rows(t.vocab) for t in cfg.tables)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = dlrm_model.init_params(cfg, gen, device=dev)
    log(f"train: dlrm-mlperf, {len(cfg.tables)} tables of dim "
        f"{cfg.embed_dim} capped at {DLRM_TRAIN_ROW_CAP} rows: {rows} rows, "
        f"{rows * cfg.embed_dim * 4 / 1e9:.2f} GB float32; batch "
        f"{DLRM_TRAIN_BATCH}")

    def loss_fn(p, b):
        return dlrm_model.loss_fn(p, cfg, b)

    batch0 = TL.to_device(next(TD.recsys_batches(cfg, DLRM_TRAIN_BATCH,
                                                 seed=1)), dev)
    g_k = grads_of(params, loss_fn, batch0)
    kernel = dlrm_model.dot_interaction
    dlrm_model.dot_interaction = dot_interaction_ref
    try:
        g_r = grads_of(params, loss_fn, batch0)
    finally:
        dlrm_model.dot_interaction = kernel
    cos = cosines(g_k, g_r)
    log(f"train: dlrm gradient through both dot_interaction kernels vs "
        f"dot_interaction_ref (f32 both): cosine per leaf min "
        f"{min(cos):.8f} (>= {DLRM_GRAD_COS})")
    if min(cos) < DLRM_GRAD_COS:
        raise AssertionError(f"train: dlrm gradient cosines {cos}")
    del g_k, g_r
    step_fn = TL.make_train_step(loss_fn, train_launch.opt_config(
        TRAIN_LR, DLRM_TRAIN_STEPS))
    state = TL.init_state(params)
    times = []
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    state, hist = TL.train(state, step_fn, TD.recsys_batches(
        cfg, DLRM_TRAIN_BATCH, seed=1), DLRM_TRAIN_STEPS, log_every=1,
        hooks=(step_timer(times),))
    launches = read_launches()
    walls = np.diff([t0] + times)
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    want = {n: 0 for n in KERNELS}
    want["dot_interaction"] = want["dot_interaction_bwd"] = DLRM_TRAIN_STEPS
    log(f"train ({card_line()}): dlrm {DLRM_TRAIN_STEPS} steps, loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; step wall "
        f"{' '.join(f'{w:.3f}' for w in walls)} s; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; launches {launches}")
    if launches != want or not losses[-1] < losses[0]:
        raise AssertionError(f"train: dlrm launches {launches} (expected "
                             f"{want}), losses {losses}")
    batch = next(TD.recsys_batches(cfg, DLRM_TRAIN_BATCH, seed=1,
                                   start_step=DLRM_TRAIN_STEPS))
    prof = device_profile(f"one dlrm-mlperf training step, batch "
                          f"{DLRM_TRAIN_BATCH}", lambda: step_fn(state, batch))
    del state, params
    return {"launches": launches, "losses": losses, "peak_bytes": peak,
            "step_s": float(np.mean(walls[1:])), "min_cos": min(cos),
            "profile": prof}


def phase_train(dev) -> dict:
    """The training paths: smollm-135m, dlrm-mlperf (its tables freed
    after), then gemma2-2b (its 42 GB of state freed after). Returns each
    run and their launches by path."""
    out = {}
    for name, phase in (("lm", lambda: phase_train_lm(dev, TRAIN_LM)),
                        ("dlrm", lambda: phase_train_dlrm(dev)),
                        ("gemma2", lambda: phase_train_lm(dev, GEMMA_TRAIN))):
        t0 = time.monotonic()
        out[name] = phase()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"train: {name} done in {time.monotonic() - t0:.1f} s; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
            f"allocated")
    return out


def dryrun_records(archs, shape: str, out_dir: str) -> dict:
    """``python -m repro_torch.launch.dryrun`` for each arch's ``shape``
    cell on the single-pod mesh, as subprocesses run side by side: their
    fake process groups of 256 ranks must not meet this process's.
    Returns the records they wrote, by arch."""
    t0 = time.monotonic()
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--mesh",
         "single", "--arch", arch, "--shape", shape, "--out",
         f"{out_dir}/{arch}"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        for arch in archs}
    recs = {}
    try:
        for arch, proc in procs.items():
            out, err = proc.communicate(timeout=600)
            path = Path(out_dir) / arch / "single" / f"{arch}__{shape}.json"
            if proc.returncode != 0 or not path.exists():
                raise AssertionError(f"dryrun {arch} {shape}: exit "
                                     f"{proc.returncode}\n{out[-2000:]}\n"
                                     f"{err[-3000:]}")
            rec = json.loads(path.read_text())
            rec["wall_s"] = time.monotonic() - t0
            if not rec["ok"] or set(rec["kernel_launches"].values()) != {0}:
                raise AssertionError(f"dryrun {arch} {shape}: {rec}")
            recs[arch] = rec
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return recs


def phase_mesh_cells(dev) -> dict:
    """The mesh cells on this card's (1, 1) mesh (a world of one):

    1. ``build_cell("smollm-135m", "train_4k", mesh)`` at published width
       and depth, its global batch of 256 x 4096 cut to MESH_CELL_BATCH
       sequences of 4096 (one card; the training phase's microbatch): the
       cell's ``step_fn`` for MESH_CELL_STEPS steps beside
       ``TL.make_train_step`` with the same loss on the same seeded state
       and batches; the loss and every parameter equal bit for bit after
       each step. The cell's run's launches are the path's.
    2. The cell's state saved (``training.checkpoint``), then
       ``ElasticMeshManager().resume`` onto the (1, 1) mesh: every leaf
       equal to the saved one bit for bit.
    3. ``python -m repro_torch.launch.dryrun --mesh single`` for smollm's
       and qwen3-moe's train_4k cells, as subprocesses side by side; their
       records print, ``ok``, with no kernel launched.

    The process group is destroyed before the phase returns."""
    from repro_torch.distribution.fault_tolerance import ElasticMeshManager
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import destroy_world, make_host_mesh
    cfg = get_config(TRAIN_ARCH)
    out = {}
    mesh = make_host_mesh((1, 1))
    try:
        cell = ST.build_cell(TRAIN_ARCH, "train_4k", mesh)
        shape = cell.shape
        log(f"mesh cells: {TRAIN_ARCH} x {shape.name} on the card's (1, 1) "
            f"mesh: global batch cut from {shape.global_batch} x "
            f"{shape.seq_len} to {MESH_CELL_BATCH} x {shape.seq_len} (one "
            f"card), {cfg.n_layers} layers at published width, AdamW "
            f"{ST.OPT_CFG}")

        def loss_fn(p, b):
            return T.lm_loss(p, cfg, b["tokens"], b["labels"], b["mask"],
                             q_chunk=1024, loss_chunk=512)

        gen = torch.Generator(device=dev).manual_seed(SEED + 40)
        params = T.init_params(cfg, gen, device=dev)     # float32 masters
        states = {"cell": TL.init_state(params),
                  "replicated": TL.init_state(tree_map(
                      lambda x: x.detach().clone(), params))}
        steps = {"cell": cell.step_fn,
                 "replicated": TL.make_train_step(loss_fn, ST.OPT_CFG)}
        batches = [TL.to_device(b, dev) for b, _ in zip(TD.lm_batches(
            cfg, MESH_CELL_BATCH, shape.seq_len, seed=3),
            range(MESH_CELL_STEPS))]
        launches = {n: 0 for n in KERNELS}
        walls = {"cell": [], "replicated": []}
        for i, b in enumerate(batches):
            b = dict(b, mask=torch.ones(b["tokens"].shape,
                                        dtype=torch.float32, device=dev))
            losses = {}
            for name in ("cell", "replicated"):
                torch.cuda.synchronize()
                if name == "cell":
                    reset_launches()
                t0 = time.monotonic()
                states[name], m = steps[name](states[name], b)
                torch.cuda.synchronize()
                walls[name].append(time.monotonic() - t0)
                if name == "cell":
                    for n, c in read_launches().items():
                        launches[n] += c
                losses[name] = m["loss"]
            same = [torch.equal(x, y) for x, y in zip(
                leaves(states["cell"].params),
                leaves(states["replicated"].params))]
            log(f"mesh cells: step {i}: loss cell {float(losses['cell']):.6f}"
                f" replicated {float(losses['replicated']):.6f} (equal bits "
                f"{torch.equal(losses['cell'], losses['replicated'])}); "
                f"{sum(same)} of {len(same)} parameter leaves equal bit for "
                f"bit; step wall cell {walls['cell'][-1]:.3f} s, replicated "
                f"{walls['replicated'][-1]:.3f} s")
            if not torch.equal(losses["cell"], losses["replicated"]) \
                    or not all(same):
                raise AssertionError(f"mesh cells: step {i} differs from the "
                                     f"replicated step")
        want = {n: 0 for n in KERNELS}
        want["flash_attention"] = cfg.n_layers * MESH_CELL_STEPS * 2
        want["flash_attention_bwd"] = cfg.n_layers * MESH_CELL_STEPS
        if launches != want:
            raise AssertionError(f"mesh cells: launches {launches}, "
                                 f"expected {want}")
        out["launches"] = launches
        out["walls"] = walls
        with tempfile.TemporaryDirectory(prefix="chip_smoke_cell_") as d:
            saved = states["cell"]._replace(ef=None)
            t0 = time.monotonic()
            CK.save(d, MESH_CELL_STEPS, saved)
            m2, _, got, _ = ElasticMeshManager(device=dev).resume(
                d, saved, cell.in_shardings[0])
            torch.cuda.synchronize()
            resume_s = time.monotonic() - t0
        pairs = list(zip(leaves(got), leaves(saved)))
        if tuple(m2.shape) != (1, 1) or not all(
                torch.equal(a.to_local(), b) for a, b in pairs):
            raise AssertionError("mesh cells: the elastic resume differs from "
                                 "the saved state")
        log(f"mesh cells: the cell's state saved and resumed onto the "
            f"{tuple(m2.shape)} mesh by ElasticMeshManager: {len(pairs)} "
            f"leaves equal bit for bit ({resume_s:.1f} s)")
        del states, got, saved, pairs
    finally:
        destroy_world()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        out["dryrun"] = dryrun_records((TRAIN_ARCH, "qwen3-moe-30b-a3b"),
                                       "train_4k", d)
        for arch, rec in out["dryrun"].items():
            log(f"dryrun record {arch} train_4k ({rec['wall_s']:.1f} s with "
                f"the interpreter, both run side by side): "
                f"{json.dumps(rec)}")
    return out


def phase_train_smoke(dev) -> dict:
    """Every arch of the registry at smoke width through the training
    launcher's code path (``train.build``, ``opt_config``,
    ``make_train_step``, ``train``) for SMOKE_TRAIN_STEPS steps on the card
    and on the CPU from the same weights (the CPU's, copied); the loss
    histories agree within SMOKE_TRAIN_ATOL (float32 configs). Then the
    launcher itself on the card for one arch. Returns the card runs'
    launches summed."""
    total = {n: 0 for n in KERNELS}
    worst = {}
    for arch in arch_ids():
        cfg, p_cpu, loss_cpu, data_cpu = train_launch.build(arch,
                                                            device="cpu")
        _, _, loss_dev, data_dev = train_launch.build(arch, device=dev)
        p_dev = tree_map(lambda t: t.detach().clone().to(dev), p_cpu)
        opt = train_launch.opt_config(TRAIN_LR, SMOKE_TRAIN_STEPS)
        hist = {}
        for name, p, lf, data in (("cpu", p_cpu, loss_cpu, data_cpu),
                                  ("cuda", p_dev, loss_dev, data_dev)):
            if name == "cuda":
                reset_launches()
            _, hist[name] = TL.train(TL.init_state(p), TL.make_train_step(
                lf, opt), data, SMOKE_TRAIN_STEPS, log_every=1)
        launches = read_launches()
        a = np.array([h["loss"] for h in hist["cuda"]])
        b = np.array([h["loss"] for h in hist["cpu"]])
        worst[arch] = float(np.abs(a - b).max())
        want = {n: 0 for n in KERNELS}
        if isinstance(cfg, TransformerConfig):
            n_fwd = cfg.n_layers * SMOKE_TRAIN_STEPS
            want["flash_attention"] = n_fwd * (2 if cfg.remat else 1)
            want["flash_attention_bwd"] = n_fwd
        if arch == "dlrm-mlperf":
            want["dot_interaction"] = SMOKE_TRAIN_STEPS
            want["dot_interaction_bwd"] = SMOKE_TRAIN_STEPS
        log(f"train smoke {arch}: card losses {' '.join(f'{x:.6f}' for x in a)}"
            f", cpu {' '.join(f'{x:.6f}' for x in b)} (max diff "
            f"{worst[arch]:.3e} <= {SMOKE_TRAIN_ATOL}); launches {launches}")
        if worst[arch] > SMOKE_TRAIN_ATOL or launches != want:
            raise AssertionError(f"train smoke {arch}: losses {a} vs {b}, "
                                 f"launches {launches} (expected {want})")
        for n in KERNELS:
            total[n] += launches[n]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         TRAIN_ARCH, "--steps", str(SMOKE_TRAIN_STEPS)],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or \
            not lines[-1].startswith("final loss"):
        raise AssertionError(f"train launcher on the card: exit "
                             f"{out.returncode}\n{out.stdout}\n{out.stderr}")
    log(f"train launcher on the card (no --device): {lines[0]} ... "
        f"{lines[-1]}")
    return {"launches": total, "worst": worst}


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
    shed = phase_shed_partition(cfg, dev)
    attn, attn_bwd = phase_flash_attention(dev)
    topk = phase_topk_select(dev)
    inter, inter_bwd = phase_dot_interaction(dev)
    kernels = [shed, attn, topk, inter, phase_flash_decode(dev), attn_bwd,
               inter_bwd, phase_score_head(dev)]
    new_shapes = phase_new_head_dims(dev)
    phase_smoke_evaluators(dev)
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
                "dot_interaction": 0, "flash_decode": 0, **NO_BACKWARD,
                "score_head": n_batches}

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
    sharded = phase_sharded(evaluate, mk, dev)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    recsys = phase_recsys(ecfg, corpus, shard, dev)
    log(f"recsys phases: {time.monotonic() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still allocated")
    decode = phase_decode(dev)
    gc.collect()
    torch.cuda.empty_cache()

    fam_seconds = {}
    t0 = time.monotonic()
    gemma = phase_gemma2_engine(ecfg, corpus, shard, dev)
    fam_seconds[f"{GEMMA} engine"] = time.monotonic() - t0
    del corpus, retrieval, shard, evaluate, mk
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    gemma_decode = phase_gemma2_decode(dev)
    fam_seconds[f"{GEMMA} decode"] = time.monotonic() - t0
    big = {}
    for arch, max_evals in BIG_EVALUATORS:
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{arch}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
            f"still allocated before the build")
        t0 = time.monotonic()
        big[arch] = phase_big_evaluator(arch, max_evals, dev)
        fam_seconds[arch] = time.monotonic() - t0
    log(f"evaluator families: seconds {json.dumps(fam_seconds)}")
    gc.collect()
    torch.cuda.empty_cache()
    train_seconds = {}
    t0 = time.monotonic()
    train = phase_train(dev)
    train_seconds["train"] = time.monotonic() - t0
    t0 = time.monotonic()
    train_smoke = phase_train_smoke(dev)
    train_seconds["train_smoke"] = time.monotonic() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    cells = phase_mesh_cells(dev)
    train_seconds["mesh_cells"] = time.monotonic() - t0
    log(f"training phases: seconds {json.dumps(train_seconds)}")

    by_path = {"engine": engine["launches"], "fleet": fleet_launches,
               "fanout": fanout["launches"], "dlrm": dlrm["launches"],
               "sharded": sharded["launches"],
               **{arch: st["launches"] for arch, st in recsys.items()},
               "decode": decode["launches"],
               f"{GEMMA} engine": gemma["launches"],
               f"{GEMMA} prefill": gemma_decode["prefill_launches"],
               f"{GEMMA} decode": gemma_decode["launches"],
               **{arch: st["launches"] for arch, st in big.items()},
               **{f"{arch.split('-')[0]} sharded": st["sharded"]["launches"]
                  for arch, st in big.items() if "sharded" in st},
               "train": {n: train["lm"]["launches"][n]
                         + train["dlrm"]["launches"][n] for n in KERNELS},
               f"{GEMMA} train": train["gemma2"]["launches"],
               "train_smoke": train_smoke["launches"],
               "train cell": cells["launches"]}
    path_launches = {name: sum(run[name] for run in by_path.values())
                     for name in KERNELS}
    instances = check_instances()
    head_instances = check_head_instances()
    for kern in kernels:
        if kern["name"] == "dot_interaction":
            kern["dlrm_feats_max_abs_err"] = dlrm["feats_err"]
            kern["max_abs_err"] = max(kern["max_abs_err"], dlrm["feats_err"])
        if kern["name"] == "topk_select":
            kern["fleet_shard_cases"] = fleet_topk
        if kern["name"] in new_shapes:
            rows, worst = new_shapes[kern["name"]]
            kern["new_shapes"] = rows
            kern["max_abs_err"] = max(kern["max_abs_err"], worst)
        kern["launches"] = path_launches[kern["name"]]
        kern["launches_by_path"] = {path: run[kern["name"]]
                                    for path, run in by_path.items()
                                    if run[kern["name"]]}
        if kern["name"] == "flash_attention":
            kern["launches_by_instance"] = instances
        if kern["name"] == "flash_decode":
            kern["launches_by_instance"] = {
                "decode": decode["by_instance"],
                f"{GEMMA} decode": gemma_decode["by_instance"]}
        if kern["name"] == "score_head":
            kern["calls_by_instance"] = head_instances
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
