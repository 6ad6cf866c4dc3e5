"""The port's ``flash_decode`` plain version (what the wrapper runs on CPU
tensors) against the TPU kernel in interpret mode (``ops.flash_decode``)
and its oracle ``ref.flash_decode_ref``, at the cases of
``tests/test_kernels.py::test_flash_decode_matches_ref`` with its
``tol(dtype)``; the poison check of
``test_flash_decode_respects_lengths``; and a row of length 0, where the
port follows the TPU kernel (zeros), not the oracle (the mean of V).
The lse output (``return_lse``): the log-sum-exp of the scores each head
sees, against ``jax.nn.logsumexp`` of the reference oracle's masked
scores within 1e-5 (-inf at length 0), and the merge of two halves of a
cache by their lse against one call over the whole cache, within
``tol``. The TMA instance's rule (``tma_instance``: gemma2's decode
heads only) and its launch counts by instance; its plain model
(``tma_split``): every valid position in exactly one segment, consumer
loads within one tile, the partials in the slots the wrapper allocates;
and its partials merged as the combine pass merges them
(``tma_merge_ref``) against the TPU kernel in interpret mode and the
plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_kernels import KEY, tol

from repro.kernels import ops, ref
from repro_torch.configs import get_config
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, tdt=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(tdt)


def _inputs(B, L, Hq, Hkv, D, jdt):
    ks = jax.random.split(KEY, 3)
    return (jax.random.normal(ks[0], (B, Hq, D), jdt),
            jax.random.normal(ks[1], (B, L, Hkv, D), jdt),
            jax.random.normal(ks[2], (B, L, Hkv, D), jdt))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,L,Hq,Hkv,D,win,cap", [
    (3, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 8, 1, 128, 100, 30.0),
    (2, 256, 8, 8, 64, 0, 0.0),
    (1, 1024, 9, 3, 64, 0, 0.0),       # smollm head layout
])
def test_flash_decode_matches_jax(B, L, Hq, Hkv, D, win, cap, dtype):
    jdt, tdt = DTYPES[dtype]
    q, kc, vc = _inputs(B, L, Hq, Hkv, D, jdt)
    lengths = np.asarray(np.arange(B) * (L // max(B, 1)) % L + 1, np.int32)
    got = flash_decode(_t(q, tdt), _t(kc, tdt), _t(vc, tdt),
                       torch.from_numpy(lengths), window=win, softcap=cap)
    assert got.dtype == tdt and tuple(got.shape) == (B, Hq, D)
    got = got.to(torch.float32).numpy()
    jl = jnp.asarray(lengths)
    for want in (ops.flash_decode(q, kc, vc, jl, window=win, softcap=cap,
                                  block_k=128, interpret=True),
                 ref.flash_decode_ref(q, kc, vc, jl, window=win,
                                      softcap=cap)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   **tol(jdt))


def test_flash_decode_respects_lengths():
    """Tokens beyond ``lengths`` must not influence the output."""
    q, kc, vc = _inputs(2, 256, 4, 4, 64, jnp.float32)
    lengths = torch.tensor([100, 37], dtype=torch.int32)
    out1 = flash_decode(_t(q), _t(kc), _t(vc), lengths)
    kc2, vc2 = _t(kc), _t(vc)
    kc2[:, 200:] = 1e4                  # poison the invalid region
    vc2[:, 200:] = -1e4
    out2 = flash_decode(_t(q), kc2, vc2, lengths)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


def test_length_zero_gives_zeros_as_the_tpu_kernel():
    q, kc, vc = _inputs(3, 256, 6, 2, 64, jnp.float32)
    lengths = np.array([0, 5, 0], np.int32)
    got = flash_decode(_t(q), _t(kc), _t(vc), torch.from_numpy(lengths),
                       window=8)
    tpu = ops.flash_decode(q, kc, vc, jnp.asarray(lengths), window=8,
                           block_k=128, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(tpu), **tol(
        jnp.float32))
    assert not got[0].any() and not got[2].any()
    oracle = ref.flash_decode_ref(q, kc, vc, jnp.asarray(lengths), window=8)
    assert np.abs(np.asarray(oracle)[0]).max() > 0   # the oracle's caveat


def test_plain_version_equals_wrapper_on_cpu():
    q, kc, vc = _inputs(2, 64, 4, 2, 16, jnp.float32)
    lengths = torch.tensor([64, 9], dtype=torch.int32)
    before = flash_decode.launches
    torch.testing.assert_close(
        flash_decode(_t(q), _t(kc), _t(vc), lengths, softcap=5.0),
        flash_decode_ref(_t(q), _t(kc), _t(vc), lengths, softcap=5.0),
        rtol=0, atol=0)
    assert flash_decode.launches == before


@pytest.mark.parametrize("shapes", [
    ((2, 4, 16), (2, 8, 3, 16), (2,)),      # Hq not a multiple of Hkv
    ((2, 4, 16), (2, 8, 2, 16), (3,)),      # lengths of another batch
    ((2, 4, 8), (2, 8, 2, 16), (2,)),       # head dims differ
])
def test_wrapper_rejects_mismatched_shapes(shapes):
    qs, cs, ls = shapes
    with pytest.raises(ValueError):
        flash_decode(torch.zeros(qs), torch.zeros(cs), torch.zeros(cs),
                     torch.zeros(ls, dtype=torch.int32))


def _lse_j(q, kc, lengths, window, softcap):
    """The oracle's scores (``ref.flash_decode_ref``'s), masked, and their
    log-sum-exp per (row, head)."""
    B, L, Hkv, D = kc.shape
    G = q.shape[1] // Hkv
    s = jnp.einsum("bhgd,bthd->bhgt",
                   q.reshape(B, Hkv, G, D).astype(jnp.float32),
                   kc.astype(jnp.float32)) * D ** -0.5
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    pos = jnp.arange(L)[None, :]
    ok = pos < lengths[:, None]
    if window > 0:
        ok &= pos > lengths[:, None] - 1 - window
    s = jnp.where(ok[:, None, None, :], s, -jnp.inf)
    return np.asarray(jax.nn.logsumexp(s, axis=-1)).reshape(B, -1)


@pytest.mark.parametrize("B,L,Hq,Hkv,D,win,cap", [
    (3, 512, 4, 2, 64, 0, 0.0),
    (2, 512, 8, 1, 128, 100, 30.0),
    (1, 1024, 9, 3, 64, 0, 0.0),
])
def test_flash_decode_lse_matches_the_oracle(B, L, Hq, Hkv, D, win, cap):
    q, kc, vc = _inputs(B, L, Hq, Hkv, D, jnp.float32)
    lengths = np.asarray(np.arange(B) * (L // B) % L + 1, np.int32)
    lengths[-1] = 0 if B > 1 else lengths[-1]
    o, lse = flash_decode(_t(q), _t(kc), _t(vc), torch.from_numpy(lengths),
                          window=win, softcap=cap, return_lse=True)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (B, Hq)
    np.testing.assert_array_equal(
        o.numpy(), flash_decode(_t(q), _t(kc), _t(vc),
                                torch.from_numpy(lengths), window=win,
                                softcap=cap).numpy())
    want = _lse_j(q, kc, jnp.asarray(lengths), win, cap)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    if B > 1:
        assert np.isneginf(lse[-1].numpy()).all()


def test_two_halves_merged_by_lse_equal_one_call():
    B, L, Hq, Hkv, D = 4, 512, 8, 2, 64
    q, kc, vc = (_t(a) for a in _inputs(B, L, Hq, Hkv, D, jnp.float32))
    lengths = torch.tensor([1, 200, 256, 500], dtype=torch.int32)
    whole = flash_decode(q, kc, vc, lengths)
    parts = [flash_decode(q, kc[:, lo:lo + L // 2].contiguous(),
                          vc[:, lo:lo + L // 2].contiguous(),
                          (lengths - lo).clamp(0, L // 2).to(torch.int32),
                          return_lse=True) for lo in (0, L // 2)]
    m = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(lse - m) for _, lse in parts]
    merged = sum(wi[..., None] * o for wi, (o, _) in zip(w, parts)) \
        / sum(w)[..., None]
    np.testing.assert_allclose(merged.numpy(), whole.numpy(),
                               **tol(jnp.float32))


DECODE_ARCHS = ["smollm-135m", "qwen2.5-14b", "gemma2-2b",
                "moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_tma_instance_takes_gemma2_decode_only(arch, smoke):
    """Of every evaluator's decode heads (the kernel's D: a smoke head is
    padded to 16), only gemma2-2b's bf16 D 256 takes the TMA instance;
    float32 never does."""
    cfg = get_config(arch, smoke=smoke)
    G, D = cfg.n_heads // cfg.n_kv_heads, max(cfg.d_head, 16)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    want = arch == "gemma2-2b" and not smoke
    assert FD.tma_instance(G, D, dtype) == want
    assert FD.instance(G, D, dtype) == ("tma" if want else "pieces")
    assert not FD.tma_instance(G, D, torch.float32)
    assert FD.tma_instance(G, 256, torch.bfloat16) == (G <= FD.MAX_GROUP)


def test_launch_counts_by_instance_name_every_instance():
    """``flash_decode.by_instance`` keeps a count for each name
    ``instance`` returns, and a CPU call counts none."""
    names = {FD.instance(G, D, dt) for G in (1, 3, 8) for D in (64, 256)
             for dt in (torch.bfloat16, torch.float32)}
    assert names == set(flash_decode.by_instance)
    before = dict(flash_decode.by_instance)
    q, kc, vc = (_t(a, torch.bfloat16)
                 for a in _inputs(2, 64, 4, 2, 256, jnp.float32))
    flash_decode(q, kc, vc, torch.tensor([64, 9], dtype=torch.int32))
    assert flash_decode.by_instance == before


def _tiles(beg, end):
    return -(-(end - beg) // FD.TMA_TILE)


@pytest.mark.parametrize("consumers", [1, 5, 132])
@pytest.mark.parametrize("window", [0, 100, 4096])
@pytest.mark.parametrize("seed", range(4))
def test_tma_split_covers_each_position_once_in_balanced_ranges(
        seed, window, consumers):
    """Over seeded lengths (0 and L among them): each row's segments tile
    its valid range [lo, hi) without overlap, in consumer order; every
    consumer's tiles are within one of every other's; each segment's slot
    is its row + its consumer, unique and inside the scratch that
    ``tma_slots`` sizes."""
    r = np.random.default_rng(seed)
    B, Hkv = int(r.integers(2, 40)), int(r.integers(1, 5))
    L = int(r.integers(1, 9000))
    lengths = r.integers(0, L + 1, size=B)
    lengths[:2] = (0, L)
    split = FD.tma_split(lengths, L, Hkv, window, consumers)
    assert len(split) == consumers
    loads = [sum(_tiles(beg, end) for _, _, beg, end in segs)
             for segs in split]
    assert max(loads) - min(loads) <= 1
    covered, slots = {}, set()
    for w, segs in enumerate(split):
        for slot, row, beg, end in segs:
            assert slot == row + w and slot not in slots
            assert 0 <= slot < FD.tma_slots(B, Hkv, consumers)
            slots.add(slot)
            assert beg < end
            covered.setdefault(row, []).append((beg, end))
    for b, length in enumerate(lengths):
        hi = min(int(length), L)
        lo = max(hi - window, 0) if window > 0 else 0
        for hk in range(Hkv):
            spans = covered.get(b * Hkv + hk, [])
            if hi == lo:
                assert not spans
                continue
            assert spans[0][0] == lo and spans[-1][1] == hi
            assert all(a[1] == n[0] for a, n in zip(spans, spans[1:]))
            assert all((beg - lo) % FD.TMA_TILE == 0 for beg, _ in spans)


@pytest.mark.parametrize("unit_tiles", [1, 4])
def test_tma_split_in_units_balances_units(unit_tiles):
    """``ab_attention.py --decode``'s ``tma_256_pieces`` variant splits in
    units of 4 tiles (a row's last unit may be shorter): consumers' units
    are within one of each other, segments start on a unit boundary."""
    lengths = np.arange(1, 61) * 97
    split = FD.tma_split(lengths, 6000, 4, 0, 132, unit_tiles)
    span = unit_tiles * FD.TMA_TILE
    units = [sum(-(-(end - beg) // span) for _, _, beg, end in segs)
             for segs in split]
    assert max(units) - min(units) <= 1
    assert all(beg % span == 0 for segs in split for _, _, beg, _ in segs)


@pytest.mark.parametrize("consumers", [3, 7, 132])
@pytest.mark.parametrize("window", [0, 100])
def test_tma_split_merged_matches_jax(window, consumers):
    """The TMA instance's two passes in plain form at gemma2's head (D
    256, G 2, softcap 50, scale 1/16), a small cache (L 512) and a window
    of 100 inside it: against the TPU kernel in interpret mode and the
    plain version within ``tol``, its lse against the oracle's within
    1e-5, zeros and -inf for a row of length 0."""
    B, L, Hq, Hkv, D = 4, 512, 4, 2, 256
    q, kc, vc = _inputs(B, L, Hq, Hkv, D, jnp.float32)
    lengths = np.array([0, 512, 77, 300], np.int32)
    kw = dict(window=window, softcap=50.0, sm_scale=0.0625)
    got, lse = FD.tma_merge_ref(_t(q), _t(kc), _t(vc), lengths,
                                consumers=consumers, **kw)
    jl = jnp.asarray(lengths)
    tpu = ops.flash_decode(q, kc, vc, jl, block_k=128, interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(tpu, np.float32),
                               **tol(jnp.float32))
    plain = flash_decode_ref(_t(q), _t(kc), _t(vc), torch.from_numpy(lengths),
                             **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **tol(jnp.float32))
    assert not got[0].any() and np.isneginf(lse[0].numpy()).all()
    s = jnp.einsum("bhgd,bthd->bhgt", q.reshape(B, Hkv, 2, D), kc) * 0.0625
    s = 50.0 * jnp.tanh(s / 50.0)
    pos = jnp.arange(L)[None, :]
    ok = pos < jl[:, None]
    if window:
        ok &= pos > jl[:, None] - 1 - window
    want = np.asarray(jax.nn.logsumexp(
        jnp.where(ok[:, None, None, :], s, -jnp.inf), axis=-1)).reshape(B, -1)
    np.testing.assert_allclose(lse[1:].numpy(), want[1:], rtol=0, atol=1e-5)
