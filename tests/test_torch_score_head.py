"""The scoring head's rule, counters and cost on the CPU, and the chunked
path it keeps there (``kernels.score_head``; the kernel itself is held to
the chunked path on the card in ``tests/test_torch_kernels_cuda.py``).

A fake CUDA tensor stands for the card here: the rule sends a bf16,
unsharded, uncapped head on it to the kernel, whose fake branch reports
the kernel's operations and bytes instead of launching."""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.kernels import score_head as SH
from repro_torch.kernels._build import kernel_costs
from repro_torch.models import transformer as T

BF16 = torch.bfloat16


def _cfg(arch="smollm-135m", **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


def _params(cfg, seed=0):
    return T.init_params(cfg, torch.Generator().manual_seed(seed))


def _head_costs(fn):
    """The kernels' reports of one call of ``fn`` on fake tensors."""
    seen = []
    with kernel_costs(lambda *a: seen.append(a)):
        fn()
    return seen


@pytest.mark.parametrize("case,want", [
    ("bf16_cuda_tied", "fused"),
    ("bf16_cuda_untied", "fused"),
    ("float32_cuda", "chunked"),
    ("bf16_cuda_f32_weight", "chunked"),
    ("softcap", "chunked"),
    ("vocab_sharded", "chunked"),
    ("bias", "chunked"),
    ("width_not_64", "chunked"),
    ("wider_than_max", "chunked"),
    ("widest_taken", "fused"),
    ("untied_vocab_not_8", "chunked"),
    ("bf16_cpu", "chunked"),
])
def test_rule_gives_each_case_its_instance(case, want):
    d, V = 128, 1000
    kw = dict(tied=True)
    mk = dict(device="cuda", dtype=BF16)
    if case == "bf16_cpu":
        x, w = torch.zeros(4, d, dtype=BF16), torch.zeros(V, d, dtype=BF16)
        assert SH.instance(x, w, **kw) == want
        return
    with FakeTensorMode():
        x = torch.empty(4, d, **mk)
        w = torch.empty(V, d, **mk)
        if case == "bf16_cuda_untied":
            w, kw = torch.empty(d, V, **mk), dict(tied=False)
        elif case == "float32_cuda":
            x, w = x.float(), w.float()
        elif case == "bf16_cuda_f32_weight":
            w = w.float()
        elif case == "softcap":
            kw["softcap"] = 30.0
        elif case == "vocab_sharded":
            kw["sharded"] = True
        elif case == "bias":
            w, kw = torch.empty(d, V, **mk), dict(tied=False, bias=True)
        elif case == "width_not_64":
            x, w = torch.empty(4, 96, **mk), torch.empty(V, 96, **mk)
        elif case in ("wider_than_max", "widest_taken"):
            dw = SH.MAX_WIDTH + (SH.WIDTH_STEP if case == "wider_than_max"
                                 else 0)
            x, w = torch.empty(4, dw, **mk), torch.empty(dw, V, **mk)
            kw = dict(tied=False)
        elif case == "untied_vocab_not_8":
            w, kw = torch.empty(d, 1001, **mk), dict(tied=False)
        assert SH.instance(x, w, **kw) == want


def _fake_head(cfg, params, B=2, T_=5, device="cuda"):
    """``_mean_token_logprob`` of fake hidden states on ``device`` in the
    config's dtype, with fake head weights of ``params``' shapes there
    too: the kernels' reports and the result."""
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    dt = getattr(torch, cfg.dtype)
    with mode:
        fp = {k: {n: torch.empty(t.shape, device=device, dtype=dt)
                  for n, t in v.items()}
              for k, v in params.items() if k in ("embed", "unembed")}
        x = torch.empty(B, T_, cfg.d_model, device=device, dtype=dt)
        tgt = torch.zeros(B, T_, dtype=torch.int32, device=device)
        out = []
        seen = _head_costs(lambda: out.append(
            T._mean_token_logprob(fp, cfg, x, tgt, 3)))
    return seen, out[0]


@pytest.mark.parametrize("arch,tied", [("smollm-135m", True),
                                       ("qwen3-moe-30b-a3b", False),
                                       ("qwen2.5-14b", False)])
def test_the_transformer_head_takes_the_kernel_on_the_card(arch, tied):
    # at the published width: qwen2.5-14b's d 5120 is the widest taken
    cfg = _cfg(arch, dtype="bfloat16", d_model=get_config(arch).d_model)
    assert cfg.tie_embeddings is tied and cfg.d_model % 64 == 0
    before = dict(SH.score_head.by_instance)
    seen, out = _fake_head(cfg, _params(cfg))
    assert [s[0] for s in seen] == ["score_head"]
    assert out.shape == (2,) and out.dtype == torch.float32
    assert SH.score_head.by_instance == {
        "fused": before["fused"] + 1, "chunked": before["chunked"]}


@pytest.mark.parametrize("case", ["float32", "softcap", "cpu", "wide"])
def test_the_transformer_head_keeps_the_chunked_path(case):
    if case == "softcap":
        cfg = _cfg("gemma2-2b", dtype="bfloat16")
        assert cfg.final_logit_softcap > 0
    elif case == "wide":
        # a head wider than any the kernel was measured at
        cfg = _cfg("qwen2.5-14b", dtype="bfloat16",
                   d_model=SH.MAX_WIDTH + SH.WIDTH_STEP)
    else:
        cfg = _cfg(dtype="float32" if case == "float32" else "bfloat16")
    before = dict(SH.score_head.by_instance)
    launches = SH.score_head.launches
    if case == "cpu":
        x = torch.randn(2, 5, cfg.d_model).to(BF16)
        p = {k: {n: t.to(BF16) for n, t in v.items()}
             for k, v in _params(cfg).items() if k in ("embed", "unembed")}
        seen = _head_costs(lambda: T._mean_token_logprob(
            p, cfg, x, torch.zeros(2, 5, dtype=torch.int32), 3))
    else:
        # a fake CPU tensor stands for the card as well (the chunked
        # path slices, which a CPU-only torch refuses on fake CUDA ones)
        seen, _ = _fake_head(cfg, _params(cfg), device="cpu")
    assert "score_head" not in [s[0] for s in seen]
    assert SH.score_head.by_instance == {
        "fused": before["fused"], "chunked": before["chunked"] + 1}
    assert SH.score_head.launches == launches


def _to_fake(mode, tree, dtype):
    if isinstance(tree, dict):
        return {k: _to_fake(mode, v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_fake(mode, v, dtype) for v in tree]
    return mode.from_tensor(tree).to(dtype)


def test_prefill_scores_through_the_same_rule():
    cfg = _cfg(dtype="bfloat16")
    params = _params(cfg)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fp = _to_fake(mode, params, BF16)
        tokens = torch.zeros(2, 9, dtype=torch.int32)
        seen = _head_costs(lambda: T.prefill(fp, cfg, tokens))
    assert "score_head" in [s[0] for s in seen]


@pytest.mark.parametrize("P,d,V", [(95232, 576, 49152), (63488, 2048, 151936),
                                   (7, 64, 1000)])
def test_fake_call_reports_the_bound_formula(P, d, V):
    with FakeTensorMode():
        x = torch.empty(P, d, dtype=BF16, device="cuda")
        w = torch.empty(V, d, dtype=BF16, device="cuda")
        t = torch.empty(P, dtype=torch.int32, device="cuda")
        seen = _head_costs(lambda: SH.score_head(x, w, t, tied=True))
        out_shape = SH.score_head(x, w, t, tied=True).shape
    # the product's multiply-adds; x, the weight and the targets read,
    # the results written
    assert seen == [("score_head", float(2 * P * d * V),
                     float(P * (2 * d + 4 + 4) + 2 * d * V))]
    assert out_shape == (P,)


def test_fake_call_makes_the_launch_checks():
    with FakeTensorMode():
        x = torch.empty(7, 96, dtype=BF16, device="cuda")
        w = torch.empty(1000, 96, dtype=BF16, device="cuda")
        t = torch.empty(7, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="multiple of 64"):
            SH.score_head(x, w, t, tied=True)
        with pytest.raises(TypeError, match="bf16"):
            SH.score_head(x.float(), w.float(), t, tied=True)
        t5 = torch.empty(5, dtype=torch.int32, device="cuda")
        with pytest.raises(ValueError, match="do not agree"):
            SH.score_head(x, w, t5, tied=True)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("chunk", [1, 3, 5, 13, 14, 100])
def test_chunked_head_equals_one_log_softmax(tied, chunk):
    """The chunked path (the CPU's, and the card's wherever the rule keeps
    it) is one float32 log-softmax over the whole vocabulary at any chunk
    budget, ragged last chunk included."""
    cfg = _cfg("smollm-135m" if tied else "qwen3-moe-30b-a3b")
    assert cfg.tie_embeddings is tied and cfg.final_logit_softcap == 0
    params = _params(cfg, seed=3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 7, cfg.d_model, generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 7), generator=g)
    tgt[0, 0], tgt[1, 6] = 0, cfg.vocab_size - 1
    before = dict(SH.score_head.by_instance)
    got = T._mean_token_logprob(params, cfg, x, tgt, chunk)
    assert SH.score_head.by_instance == {
        "fused": before["fused"], "chunked": before["chunked"] + 1}
    w = params["embed"]["table"].T if tied else params["unembed"]["w"]
    lp = torch.log_softmax(x @ w, dim=-1).gather(-1, tgt[..., None])[..., 0]
    torch.testing.assert_close(got, lp.mean(dim=-1), rtol=0, atol=2e-6)


def test_chunked_head_in_bf16_rounds_the_logits_first():
    """In bf16 the chunked path's logits are the bf16 product, as the
    kernel's accumulators are rounded before the softmax."""
    cfg = _cfg(dtype="bfloat16", vocab_size=300, d_model=64)
    g = torch.Generator().manual_seed(7)
    x = torch.randn(5, 64, generator=g).to(BF16)
    w = torch.randn(300, 64, generator=g).to(BF16)
    t = torch.tensor([0, 299, 255, 256, 17])
    got = T._chunked_token_logprob({"embed": {"table": w}}, cfg, x, t, 2)
    logits = (x @ w.T).float()
    want = logits.gather(-1, t[:, None])[:, 0] - logits.logsumexp(-1)
    assert torch.equal(got, want)


def test_kernel_refuses_cpu_tensors():
    """The kernel runs on the card alone: the rule sends CPU tensors to
    the chunked path, and a direct call on them raises."""
    x, w = torch.zeros(4, 64, dtype=BF16), torch.zeros(100, 64, dtype=BF16)
    launches = SH.score_head.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        SH.score_head(x, w, torch.zeros(4, dtype=torch.int32), tied=True)
    assert SH.score_head.launches == launches


def test_timer_exits_2_without_a_card():
    """``launch/time_score_head.py`` imports without a card and exits 2
    before building or timing anything."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(root / "src/repro_torch/launch/"
                             "time_score_head.py")],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(root))
    assert out.returncode == 2, (out.stdout, out.stderr)
    assert "no CUDA device" in out.stderr and out.stdout == ""


def test_timer_shapes_are_the_evaluators_steps():
    from repro_torch.launch import time_score_head as TSH
    for arch, (P, d, V, tied) in TSH.SHAPES.items():
        cfg = get_config(arch, smoke=False)
        assert (d, V, tied) == (cfg.d_model, cfg.vocab_size,
                                cfg.tie_embeddings)
        assert P % 31 == 0
        head = TSH.head_config(tied, V)
        assert T._token_chunk(head) == T._token_chunk(cfg)


@pytest.mark.parametrize("tied", [True, False])
def test_timer_plain_path_is_the_transformer_head(tied):
    """``time_score_head.plain`` is the transformer's own chunked head
    over the same weight, bit for bit."""
    from repro_torch.launch import time_score_head as TSH
    cfg = _cfg("smollm-135m" if tied else "qwen3-moe-30b-a3b")
    params = _params(cfg, seed=5)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(9, cfg.d_model, generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (9,), generator=g)
    w = params["embed"]["table"] if tied else params["unembed"]["w"]
    want = T._chunked_token_logprob(params, cfg, x, tgt, 4)
    assert torch.equal(TSH.plain(x, w, tgt, tied, token_chunk=4), want)
