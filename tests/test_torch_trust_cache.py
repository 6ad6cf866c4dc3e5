"""Trust DB and average-trust prior of the torch port
(``repro_torch.core.trust_cache`` / ``average_trust``) against the JAX
reference on the same seeded numpy inputs: hash, insert and lookup are
bit-exact in both cache layouts; the prior update agrees to rtol 1e-6
(``index_add_`` and ``segment_sum`` sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import average_trust as AT_j
from repro.core import trust_cache as TC_j
from repro_torch.core import average_trust as AT_t
from repro_torch.core import trust_cache as TC_t


def _t(keys_u32):
    return torch.from_numpy(np.ascontiguousarray(keys_u32, np.uint32)
                            .view(np.int32))


# One compile per shape: every round below uses the same batch size.
_insert_j = jax.jit(TC_j.insert)
_lookup_j = jax.jit(TC_j.lookup)


def _state_np(state):
    out = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in state.items()}
    out["keys"] = out["keys"].view(np.uint32)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash32_bit_exact(seed):
    r = np.random.default_rng(seed)
    x = r.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    want = np.asarray(TC_j._hash32(jnp.asarray(x)))
    got = TC_t._hash32(_t(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


@pytest.mark.parametrize("ways_leading", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_insert_lookup_sequence_bit_exact(ways_leading, seed):
    """Random insert/lookup rounds with duplicate keys, colliding slots
    and keys with the top bit set in one batch: keys, values, age and
    clock equal the reference after every round."""
    r = np.random.default_rng(seed)
    n_slots, n_ways = 64, 4
    sj = TC_j.init(n_slots, n_ways, ways_leading=ways_leading)
    st = TC_t.init(n_slots, n_ways, ways_leading=ways_leading,
                   device="cpu")
    pool = r.integers(1, 2 ** 32, size=300, dtype=np.uint64).astype(
        np.uint32)
    pool[:8] = 0x80000000 + np.arange(8, dtype=np.uint32)
    n = 160
    for _ in range(6):
        keys = r.choice(pool, size=n)              # duplicates in-batch
        keys[r.random(n) < 0.05] = 0               # reserved empty key
        vals = r.uniform(0, 5, size=n).astype(np.float32)
        mask = r.random(n) < 0.8
        sj = _insert_j(sj, jnp.asarray(keys), jnp.asarray(vals),
                       jnp.asarray(mask))
        st = TC_t.insert(st, _t(keys), torch.from_numpy(vals),
                         torch.from_numpy(mask))
        a, b = _state_np(sj), _state_np(st)
        for k in ("keys", "values", "age", "clock"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        probe = np.concatenate([keys, r.choice(pool, size=50)])
        vj, hj = _lookup_j(sj, jnp.asarray(probe))
        vt, ht = TC_t.lookup(st, _t(probe))
        np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert float(TC_t.occupancy(st)) == pytest.approx(
        float(TC_j.occupancy(sj)))


def test_insert_is_functional_and_handles_empty_batch():
    st = TC_t.init(16, 2, device="cpu")
    before = {k: v.clone() for k, v in st.items()}
    new = TC_t.insert(st, _t(np.array([5, 6], np.uint32)),
                      torch.tensor([1.0, 2.0]), torch.tensor([True, True]))
    for k in before:
        assert torch.equal(st[k], before[k])        # input state untouched
    assert int(new["clock"]) == 1
    empty = TC_t.insert(new, _t(np.zeros(0, np.uint32)),
                        torch.zeros(0), torch.zeros(0, dtype=torch.bool))
    assert int(empty["clock"]) == 2
    assert torch.equal(empty["keys"], new["keys"])


def test_dims_reads_both_layouts():
    assert TC_t.dims((4, 64)) == TC_j.dims((4, 64)) == (64, 4, True)
    assert TC_t.dims((64, 4)) == TC_j.dims((64, 4)) == (64, 4, False)
    with pytest.raises(ValueError):
        TC_t.init(4, 4, device="cpu")


@pytest.mark.parametrize("n_buckets", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_average_trust_update_and_query(n_buckets, seed):
    r = np.random.default_rng(seed)
    pj = AT_j.init(n_buckets)
    pt = AT_t.init(n_buckets, device="cpu")
    for _ in range(4):
        n = int(r.integers(1, 500))
        buckets = r.integers(0, 50, size=n).astype(np.int32)
        vals = r.uniform(0, 5, size=n).astype(np.float32)
        mask = r.random(n) < 0.7
        pj = AT_j.update(pj, jnp.asarray(buckets), jnp.asarray(vals),
                         jnp.asarray(mask), ewma=0.05)
        pt = AT_t.update(pt, torch.from_numpy(buckets),
                         torch.from_numpy(vals), torch.from_numpy(mask),
                         ewma=0.05)
        for k in ("mean", "count"):
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6)
        q = r.integers(0, 50, size=64).astype(np.int32)
        np.testing.assert_allclose(
            AT_t.query(pt, torch.from_numpy(q)).numpy(),
            np.asarray(AT_j.query(pj, jnp.asarray(q))), rtol=1e-6)
