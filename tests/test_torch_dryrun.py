"""The dry-run (``repro_torch.launch.dryrun`` / ``launch.hlo_analysis``) in
a subprocess, at smoke width: a fake process group of 8 ranks on a
(data=4, model=2) mesh, then a fake world of one on (1, 1), each tracing
the same cells (smollm-135m and qwen3-moe train and decode steps, dlrm
training, a padded GCN graph, MIND retrieval) on fake tensors.

- Every record has the reference's keys (``ok``, the cell's numbers,
  ``memory``, ``cost``, ``analysis`` with ``flops`` / ``hbm_bytes`` /
  ``collective_bytes`` / ``collectives`` / ``collective_counts``) and
  ``trace_s``.
- No kernel launched (every launch counter unchanged) while the traced
  steps went through the kernels' fake branches (their calls recorded).
- A cell whose heads the kernels refuse (9 query heads per KV head in a
  decode step; a head of 48 in a train step) fails its trace with the
  launch's own error: a kernel wrapper makes every check of a launch
  before its fake branch.
- smollm's train and decode work splits evenly over the 8 ranks (heads,
  FFN and vocab over ``model``, rows over ``data``, the decode cache's
  sequence over ``model``): the per-rank FLOPs times 8 equal the world of
  one's within 1%. A world of one runs no collective; the 8-rank traces
  do.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

_SCRIPT = r'''
import dataclasses, json, os, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as DR

out = sys.argv[1]
LM_TRAIN = ShapeSpec(name="train_4k", kind="train", seq_len=64,
                     global_batch=8)
LM_DECODE = ShapeSpec(name="decode_32k", kind="decode", seq_len=64,
                      global_batch=8)
CASES = [("smollm-135m", LM_TRAIN), ("smollm-135m", LM_DECODE),
         ("qwen3-moe-30b-a3b", LM_TRAIN), ("qwen3-moe-30b-a3b", LM_DECODE),
         ("dlrm-mlperf", ShapeSpec(name="train_batch", kind="train",
                                   batch=64)),
         ("gcn-cora", ShapeSpec(name="ogb_products", kind="graph_full",
                                n_nodes=500, n_edges=1500, d_feat=12)),
         ("mind", ShapeSpec(name="retrieval_cand", kind="retrieval",
                            batch=1, n_candidates=4096))]
recs = {}
for world, shape in ((8, (4, 2)), (1, (1, 1))):
    d = f"{out}/w{world}"
    os.makedirs(d, exist_ok=True)
    mesh = DR.fake_world(shape, ("data", "model"), DR.trace_device())
    for arch, sh in CASES:
        cfg = get_config(arch, smoke=True)
        if getattr(cfg, "moe", None) is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch="ep_shard_map"))
        recs[f"{world}|{arch}|{sh.name}"] = DR.run_cell(
            arch, sh.name, f"w{world}", d, mesh=mesh, cfg=cfg, shape=sh)
with open(f"{out}/all.json", "w") as f:
    json.dump(recs, f)
# head geometries the kernels refuse on the card: the trace refuses them
smollm = get_config("smollm-135m", smoke=True)
REFUSED = {"G9_decode": (dataclasses.replace(smollm, n_heads=18), LM_DECODE),
           "D48_train": (dataclasses.replace(smollm, d_head=48), LM_TRAIN)}
refused = {name: DR.run_cell("smollm-135m", sh.name, "w1", f"{out}/w1",
                             mesh=mesh, cfg=cfg, shape=sh)
           for name, (cfg, sh) in REFUSED.items()}
with open(f"{out}/refused.json", "w") as f:
    json.dump(refused, f)
'''


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", _SCRIPT, str(out)], env=ENV,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out / "all.json") as f:
        recs = json.load(f)
    with open(out / "refused.json") as f:
        return recs, json.load(f)


@pytest.fixture(scope="module")
def records(traces):
    return traces[0]


def test_records_have_the_reference_keys(records):
    assert len(records) == 14
    for name, rec in records.items():
        assert rec["ok"], (name, rec.get("error"), rec.get("traceback"))
        for k in ("arch", "shape", "mesh", "n_devices", "kind",
                  "loop_multiplier", "n_params", "n_active_params",
                  "useful_flops_fwd", "tokens", "trace_s", "memory",
                  "cost", "analysis"):
            assert k in rec, (name, k)
        assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                      "temp_bytes", "alias_bytes"}
        assert set(rec["cost"]) == {"flops", "bytes_accessed"}
        a = rec["analysis"]
        assert set(a) >= {"flops", "hbm_bytes", "collective_bytes",
                          "collectives", "collective_counts"}
        assert a["flops"] > 0 and a["hbm_bytes"] > 0
        assert rec["memory"]["argument_bytes"] > 0
        assert rec["n_devices"] == int(name.split("|")[0])


def test_no_kernel_launches_on_fake_tensors(records):
    for name, rec in records.items():
        assert set(rec["kernel_launches"].values()) == {0}, name
    kernels = {k for rec in records.values()
               for k in rec["analysis"]["kernels"]}
    assert {"flash_attention", "flash_attention_bwd", "flash_decode",
            "dot_interaction", "dot_interaction_bwd"} <= kernels


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_per_rank_flops_times_ranks_equal_a_world_of_one(records, shape):
    eight = records[f"8|smollm-135m|{shape}"]["analysis"]["flops"]
    one = records[f"1|smollm-135m|{shape}"]["analysis"]["flops"]
    assert abs(8 * eight - one) <= 0.01 * one, (eight, one)


def test_collectives_only_across_ranks(records):
    for name, rec in records.items():
        coll = rec["analysis"]["collective_bytes"]
        if name.startswith("1|"):
            assert coll == 0, name
        elif "smollm" in name or "qwen3" in name:
            assert coll > 0, name


@pytest.mark.parametrize("case, message", [
    ("G9_decode", "query heads per KV head"),
    ("D48_train", "takes D in")])
def test_trace_refuses_what_a_launch_refuses(traces, case, message):
    """A cell whose heads a kernel would refuse on the card fails its
    trace with the launch's error: 9 query heads per KV head in the
    decode kernel, a head of 48 in the attention kernel."""
    rec = traces[1][case]
    assert not rec["ok"], case
    assert message in rec["error"], rec["error"]
