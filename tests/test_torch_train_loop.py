"""The port's ``make_train_step`` and training launcher on the CPU:

- three ``make_train_step`` steps (``grad_accum`` 1 and 2, compression
  off and on) against the reference's ``TL.make_train_step`` from the
  same weights and batches: losses and metrics (``ef_l1`` included)
  within 1e-5, parameters and Adam moments within 1e-3 and 2e-3 of each
  leaf's norm after the updates (``STATE_REL`` says why);
- ``python -m repro_torch.launch.train --device cpu`` for an LM, a
  recommender and ``gcn-cora`` exits 0 with the reference's lines, a
  ``--resume`` run continues where the checkpoint left off, and an
  unknown ``--arch`` exits 2."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_j
from repro.training import data as D_j
from repro.training import optimizer as O_j
from repro.training import train_loop as TL_j
from repro_torch.training import optimizer as O
from repro_torch.training import train_loop as TL
from repro_torch.training.tree import leaves
from test_torch_train import _assert_leaves_close, _setup

ROOT = Path(__file__).resolve().parents[1]
# Adam's m / sqrt(v) divides out a gradient's scale, so an entry whose
# gradient is rounding noise moves by up to lr a step, in whichever
# direction its framework's noise points; with compression a gradient
# that differs in its last bits can fall on the other side of an int8
# rounding boundary and move its code by one. Measured after three
# steps: parameters within 2.5e-4 of a leaf's norm, moments within
# 5.8e-4 (1.3e-3 with compression).
STATE_REL = {"params": 1e-3, "m": 2e-3, "v": 2e-3}


@pytest.mark.parametrize("grad_accum,compress", [(1, False), (2, False),
                                                 (1, True), (2, True)])
def test_three_train_steps_match_the_reference(grad_accum, compress):
    arch = "smollm-135m"
    loss_j, params, loss_t, pt, _ = _setup(arch)
    cfg = get_config_j(arch, smoke=True)
    opt_j = O_j.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    opt = O.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=3)
    step_j = TL_j.make_train_step(loss_j, opt_j, grad_accum=grad_accum,
                                  compress_grads=compress, jit=False)
    step = TL.make_train_step(loss_t, opt, grad_accum=grad_accum,
                              compress_grads=compress)
    state_j = TL_j.init_state(jax.tree.map(jnp.asarray, params), compress)
    state = TL.init_state(pt, compress)
    data = D_j.lm_batches(cfg, 4 * grad_accum, 32, seed=1)
    for _ in range(3):
        b = next(data)
        if grad_accum > 1:
            b = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                 for k, v in b.items()}
        state_j, m_j = step_j(state_j, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        state, m = step(state, b)
        assert set(m) == set(m_j)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(m_j[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(state.opt.step) == int(state_j.opt.step) == 3
    for got, want, what in ((state.params, state_j.params, "params"),
                            (state.opt.m, state_j.opt.m, "m"),
                            (state.opt.v, state_j.opt.v, "v")):
        _assert_leaves_close(leaves(got), jax.tree.leaves(want),
                             rel=STATE_REL[what], what=what)


def _launch(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           "--device", "cpu", *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT))


@pytest.mark.parametrize("arch", ["smollm-135m", "dlrm-mlperf", "gcn-cora"])
def test_cpu_launcher_prints_the_reference_lines(arch):
    out = _launch("--arch", arch, "--steps", "3")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch} (smoke) params=")
    assert lines[0].endswith("steps=3")
    steps = [l.split() for l in lines if l.strip().startswith("step ")]
    assert [int(s[1]) for s in steps] == [0, 1, 2]
    assert all(s[2] == "loss" and s[4] == "lr" for s in steps)
    assert np.isfinite([float(s[3]) for s in steps]).all()
    assert lines[-1].startswith("final loss ")


def test_cpu_launcher_resumes_from_its_checkpoint(tmp_path):
    ck = str(tmp_path / "ck")
    first = _launch("--arch", "bst", "--steps", "4", "--ckpt-dir", ck,
                    "--ckpt-every", "2")
    assert first.returncode == 0, first.stderr
    again = _launch("--arch", "bst", "--steps", "6", "--ckpt-dir", ck,
                    "--ckpt-every", "2", "--resume")
    assert again.returncode == 0, again.stderr
    assert "resumed at step 4" in again.stdout


def test_unknown_arch_exits_2_listing_the_registry():
    out = _launch("--arch", "nope", "--steps", "1", timeout=60)
    assert out.returncode == 2 and "smollm-135m" in out.stderr


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with no "
                    "CUDA device")
def test_build_defaults_to_the_card_and_raises_without_one():
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.build("smollm-135m")
    cfg, params, _, _ = train.build("smollm-135m", device="cpu")
    assert all(p.device.type == "cpu" for p in leaves(params))
