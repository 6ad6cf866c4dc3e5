"""The port's fault-tolerant checkpoints (``training.checkpoint``) on the
CPU: a round trip of a train state (nested dicts, lists, the AdamW
NamedTuple, a ``None`` EF state) with the reference's on-disk layout
(``step_<N>/manifest.json``, ``leaves_<i>.npz``, sha256 checksums,
``LATEST``), a save that the reference's ``restore`` reads back; a
``.tmp`` directory left by a crash is ignored; a corrupt checksum raises
``IOError``; retention keeps ``keep_last``; ``AsyncCheckpointer`` raises
a worker's error on the next ``wait``; and a restart from a checkpoint
reproduces the straight run bit for bit (the port's twin of
``tests/test_integration_train.py::test_checkpoint_restart_is_bit_identical``)."""
import json
import os

import numpy as np
import pytest
import torch

from repro.training import checkpoint as CK_j
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as CK
from repro_torch.training import data as D
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(70, 3, generator=g),
              "layers": [{"b": torch.randn(5, generator=g)}
                         for _ in range(70)]}      # > 64 leaves: two files
    return TL.init_state(params)


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_round_trip_and_layout(tmp_path):
    st = _state()
    final = CK.save(str(tmp_path), 7, st, extra={"step": 7})
    assert os.path.basename(final) == "step_00000007"
    assert (tmp_path / "LATEST").read_text() == "step_00000007"
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["n_files"] == 4 and set(man["files"]) == {
        f"leaves_{i:04d}.npz" for i in range(4)}
    assert [e["path"] for e in man["leaves"]][:2] == [
        ".params['layers'][0]['b']", ".params['layers'][1]['b']"]
    assert CK.latest_step(str(tmp_path)) == 7
    fresh = _state(seed=1)
    got, extra = CK.restore(str(tmp_path), fresh)
    assert extra == {"step": 7} and isinstance(got, TL.TrainState)
    assert got.ef is None and isinstance(got.opt, O.AdamWState)
    _equal(got, st)


def test_the_reference_restores_a_port_checkpoint(tmp_path):
    st = _state()
    CK.save(str(tmp_path), 3, st)
    like = [np.zeros_like(leaf.numpy()) for leaf in leaves(st)]
    got, _ = CK_j.restore(str(tmp_path), like)
    for a, b in zip(got, leaves(st)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_a_crashed_tmp_save_is_ignored(tmp_path):
    st = _state()
    CK.save(str(tmp_path), 1, st)
    (tmp_path / "step_00000002.tmp").mkdir()
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("partial")
    assert CK.latest_step(str(tmp_path)) == 1
    got, _ = CK.restore(str(tmp_path), _state(seed=2))
    _equal(got, st)
    CK.save(str(tmp_path), 2, st)                     # replaces the .tmp
    assert CK.latest_step(str(tmp_path)) == 2


def test_corrupt_checksum_raises(tmp_path):
    CK.save(str(tmp_path), 5, _state())
    f = tmp_path / "step_00000005" / "leaves_0000.npz"
    data = bytearray(f.read_bytes())
    data[len(data) // 2] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(IOError, match="checksum"):
        CK.restore(str(tmp_path), _state())


def test_structure_mismatch_raises(tmp_path):
    CK.save(str(tmp_path), 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure"):
        CK.restore(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        CK.restore(str(tmp_path), {"a": torch.zeros(4)})


def test_retention_keeps_the_last_ones(tmp_path):
    for s in range(1, 6):
        CK.save(str(tmp_path), s, {"a": torch.full((2,), float(s))},
                keep_last=2)
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000004",
                                            "step_00000005"]


def test_async_checkpointer_raises_a_worker_error_on_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("a file where the directory should go")
    ck = CK.AsyncCheckpointer(str(blocker))
    ck.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                  # the error is raised once
    good = CK.AsyncCheckpointer(str(tmp_path / "ok"))
    good.save(1, {"a": torch.ones(2)})
    good.wait()
    assert CK.latest_step(str(tmp_path / "ok")) == 1


def test_checkpoint_restart_is_bit_identical(tmp_path):
    cfg = get_config("smollm-135m", smoke=True)
    opt = O.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=6)

    def loss_fn(p, b):
        return T.lm_loss(p, cfg, b["tokens"], b["labels"])

    def fresh():
        return TL.init_state(T.init_params(
            cfg, torch.Generator().manual_seed(0)))

    step = TL.make_train_step(loss_fn, opt)
    straight, _ = TL.train(fresh(), step, D.lm_batches(cfg, 2, 16, seed=1),
                           6, log_every=0)
    ck = CK.AsyncCheckpointer(str(tmp_path))
    TL.train(fresh(), step, D.lm_batches(cfg, 2, 16, seed=1), 3,
             log_every=0, checkpointer=ck, ckpt_every=3)
    restored, extra = CK.restore(str(tmp_path), fresh())
    assert extra["step"] == 3 and int(restored.opt.step) == 3
    again, _ = TL.train(restored, step,
                        D.lm_batches(cfg, 2, 16, seed=1, start_step=3), 3,
                        log_every=0, start_step=3)
    _equal(again, straight)
