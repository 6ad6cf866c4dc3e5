"""The system under test, and the taps the benchmark reads from it.

The only module of the benchmark that imports the system (the
PyTorch/CUDA package ``repro_torch``). It builds the serving path the
cells drive, ``serving.engine.ServingEngine`` in fused mode over
``serving.evaluators.make_evaluator`` (with the benchmark's weights) and,
for search traffic, ``retrieval.shard.CorpusRetrieval`` over the
benchmark's corpus, and records what the system hands back:

* every finished micro-batch as the scheduler splits it (its keys, tiers,
  trust, and which request holds which rows);
* every fused step's load-monitor inputs (Ucapacity, Uthreshold, the
  evaluation budget and the evaluator's row count), in dispatch order;
* every search's candidate ids and BM25 scores as the index shard
  returned them, and its host time;
* every response, stamped with the host time at which it came back.

The taps wrap bound methods of this engine's own objects and change
nothing they return.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.traffic_gen import Request, item_tokens

_MODEL_KEYS = (("n_layers", "num_hidden_layers"), ("d_model", "hidden_size"),
               ("n_heads", "num_attention_heads"),
               ("n_kv_heads", "num_key_value_heads"), ("d_head", "head_dim"),
               ("vocab_size", "vocab_size"),
               ("tie_embeddings", "tie_word_embeddings"),
               ("rope_theta", "rope_theta"), ("norm_eps", "rms_norm_eps"))


def _check_arch(port_cfg, m: Dict, dtype: str) -> None:
    """Refuse to run when the system's configuration of the arch is not
    the one the configuration file states."""
    diff = [(k, getattr(port_cfg, a), m[k]) for a, k in _MODEL_KEYS
            if getattr(port_cfg, a) != m[k]]
    if port_cfg.act != m["hidden_act"]:
        diff.append(("hidden_act", port_cfg.act, m["hidden_act"]))
    if port_cfg.dtype != dtype:
        diff.append(("dtype", port_cfg.dtype, dtype))
    if port_cfg.qkv_bias or port_cfg.sliding_window or port_cfg.post_norm:
        diff.append(("extras", "bias/window/post-norm", "none"))
    moe = port_cfg.moe
    if m.get("num_experts"):
        want = {"n_experts": m["num_experts"],
                "top_k": m["num_experts_per_tok"],
                "d_expert": m["moe_intermediate_size"],
                "capacity_factor": m["capacity_factor"],
                "norm_topk_prob": m["norm_topk_prob"],
                "n_shared_experts": 0, "first_k_dense": 0}
        if moe is None:
            diff.append(("moe", None, want))
        else:
            diff += [(k, getattr(moe, k), v) for k, v in want.items()
                     if getattr(moe, k) != v]
    elif moe is not None or port_cfg.d_ff != m["intermediate_size"]:
        diff.append(("intermediate_size", port_cfg.d_ff,
                     m["intermediate_size"]))
    if diff:
        raise SystemExit(f"the system's {port_cfg.name} is not the "
                         f"configuration file's: {diff}")


class System:
    """One ServingEngine as a cell configures it, with its taps."""

    def __init__(self, config: Dict, traffic: Dict, seed: int, tree: Dict,
                 device, corpus=None):
        from repro_torch.configs import get_config, trust_ir
        from repro_torch.scheduling import Priority
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.evaluators import make_evaluator

        self.Priority = Priority
        serving = config["serving"]
        smoke = bool(config.get("smoke", False))
        _check_arch(get_config(config["arch"], smoke=smoke), config["model"],
                    config["dtype"])
        self.cfg = dataclasses.replace(
            trust_ir.config(), drain_mode="fused",
            pipeline_depth=int(serving["pipeline_depth"]))
        stated = {k: getattr(self.cfg, k) for k in serving
                  if hasattr(self.cfg, k) and serving[k] != getattr(
                      self.cfg, k)}
        if stated:
            raise SystemExit(f"the system's serving settings differ from "
                             f"the configuration file's: {stated}")
        self.top_k = traffic.get("query", {}).get("top_k")
        self.seed = seed
        self.doc_len = int(traffic["doc_tokens"])
        self.vocab = int(config["model"]["vocab_size"])
        evaluate, _ = make_evaluator(
            config["arch"], smoke=smoke, params=tree, device=device,
            doc_len=self.doc_len, trust_scale=self.cfg.trust_scale)
        self.searches: List = []          # (ids, scores) per shard call
        self.search_s: List[float] = []   # host seconds per search
        retriever = None
        if traffic["kind"] == "search":
            from repro_torch.retrieval.shard import CorpusRetrieval
            retrieval = CorpusRetrieval(
                corpus, n_partitions=self.cfg.index_partitions,
                block_docs=self.cfg.index_block_docs,
                feature_fn=self._doc_features, device=device)
            shard = retrieval.build_shard(range(self.cfg.index_partitions))
            shard._ensure_dense()
            inner = shard.retrieve

            def retrieve(query, k):
                ids, scores = inner(query, k)
                self.searches.append((query, ids, scores))
                return ids, scores

            shard.retrieve = retrieve
            retriever = _TimedSearcher(retrieval.searcher([shard]),
                                       self.search_s)
        self.engine = ServingEngine(
            self.cfg, evaluate,
            fused_max_evals=serving.get("fused_max_evals"),
            retriever=retriever, device=device)
        self.max_batch = self.engine.scheduler.max_batch_items
        # taps: the fused step's monitor inputs, finished batches
        self.steps: List = []
        self.batches: List[Dict] = []
        shedder = self.engine.shedder
        step = shedder._step

        def tapped_step(*args):
            self.steps.append(tuple(int(a) for a in args[6:10]))
            return step(*args)

        shedder._step = tapped_step
        ex = self.engine.scheduler.executor
        finalize = ex._finalize

        def tapped_finalize(batch, shed):
            self.batches.append({
                "keys": np.asarray(batch.item_keys, np.uint32),
                "tier": np.asarray(shed.tier), "trust": np.asarray(shed.trust),
                "n_valid": int(batch.n_valid),
                "slices": [(q.request.request_id, s, ln)
                           for q, s, ln in batch.slices],
                "t": time.monotonic()})
            return finalize(batch, shed)

        ex._finalize = tapped_finalize
        self._seen = 0

    def _doc_features(self, docs: np.ndarray) -> Dict[str, np.ndarray]:
        return {"tokens": item_tokens(self.seed, np.asarray(docs) + 1,
                                      self.vocab, self.doc_len)}

    # -- the front doors ---------------------------------------------------
    def offer(self, req: Request) -> int:
        prio = self.Priority[req.priority]
        if req.query is not None:
            return self.engine.enqueue_query(req.query, self.top_k,
                                             priority=prio,
                                             tenant=req.tenant)
        keys = req.keys
        return self.engine.enqueue(
            keys, (keys % 256).astype(np.int32),
            {"tokens": item_tokens(self.seed, keys, self.vocab,
                                   self.doc_len)},
            priority=prio, tenant=req.tenant)

    def drain_one(self) -> None:
        self.engine.drain(1, flush=False)

    def poll(self) -> None:
        self.engine.poll()

    def flush(self) -> None:
        self.engine.flush()

    def queued_items(self) -> int:
        return self.engine.scheduler.queued_items

    def in_flight(self) -> int:
        return self.engine.scheduler.executor.in_flight

    def new_responses(self) -> List:
        """Responses the engine handed back since the last call."""
        done = self.engine.completed
        out = done[self._seen:]
        self._seen = len(done)
        return out

    def stats(self) -> Dict:
        return self.engine.scheduler_stats()

    def prior_mean(self) -> float:
        return float(self.engine.shedder.prior["mean"][0])


class _TimedSearcher:
    """The engine's retriever: the system's searcher, with the host time
    of each search kept (the call ends in a device-to-host copy)."""

    def __init__(self, inner, sink: List[float]):
        self.inner, self.sink = inner, sink

    def search(self, query, n_results):
        t0 = time.perf_counter()
        res = self.inner.search(query, n_results)
        self.sink.append(time.perf_counter() - t0)
        return res


def release(system: Optional[System]) -> None:
    """Free the engine's device state before the reference runs."""
    if system is not None:
        system.engine = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
