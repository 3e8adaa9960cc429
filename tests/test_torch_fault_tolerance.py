"""The port's fault-tolerant controller: the twins of
``tests/test_fault_tolerance.py``; on the CPU a restart replays to the
uninterrupted run's parameters bit for bit."""

import numpy as np
import pytest
import torch

from _torch_train import models
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train.fault_tolerance import (FailureInjector,
                                               StragglerStats,
                                               TrainController)
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")
OPT = OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def _setup():
    _, _, cfg, params = models("qwen2-7b")
    step = make_train_step(cfg, OPT)
    data = SyntheticLM(cfg.vocab_size, batch=2, seq_len=32, seed=1)

    def data_fn(step_idx):
        return {k: torch.from_numpy(v) for k, v in data(step_idx).items()}

    return (params, init_opt_state(params)), step, data_fn


def test_run_without_failures(tmp_path):
    state, step, data_fn = _setup()
    ctl = TrainController(step, tmp_path / "ck", ckpt_every=4)
    state, log = ctl.run(state, data_fn, n_steps=6)
    losses = [e["loss"] for e in log if "loss" in e]
    assert len(losses) == 6
    assert all(np.isfinite(losses))
    assert int(state[1]["step"]) == 6


def test_failure_restart_matches_uninterrupted_bit_for_bit(tmp_path):
    """Kill the 'node' mid-run; the restart replays to exactly the final
    parameters and optimizer state of an uninterrupted run."""
    state_a, step, data_fn = _setup()
    ctl_a = TrainController(step, tmp_path / "a", ckpt_every=3)
    state_a, _ = ctl_a.run(state_a, data_fn, n_steps=9)

    state_b, step_b, data_fn_b = _setup()
    ctl_b = TrainController(step_b, tmp_path / "b", ckpt_every=3,
                            injector=FailureInjector(at_steps=[5, 7]))
    state_b, log_b = ctl_b.run(state_b, data_fn_b, n_steps=9)
    assert ctl_b.restarts == 2
    assert [e["step"] for e in log_b if e.get("event") == "restart"] == [3, 6]
    for a, b in zip(leaves(state_a), leaves(state_b)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_failure_before_any_checkpoint_replays_from_the_start(tmp_path):
    """No checkpoint on disk yet: the replay starts from the state the
    run started from, not the current one."""
    state_a, step, data_fn = _setup()
    state_a, _ = TrainController(step, tmp_path / "a", ckpt_every=100).run(
        state_a, data_fn, n_steps=4)
    state_b, step_b, data_fn_b = _setup()
    ctl = TrainController(step_b, tmp_path / "b", ckpt_every=100,
                          injector=FailureInjector(at_steps=[2]))
    state_b, log = ctl.run(state_b, data_fn_b, n_steps=4)
    assert ctl.restarts == 1
    assert [e["step"] for e in log if e.get("event") == "restart"] == [0]
    for a, b in zip(leaves(state_a), leaves(state_b)):
        assert torch.equal(a, b)


def test_restart_budget(tmp_path):
    state, step, data_fn = _setup()
    ctl = TrainController(step, tmp_path / "c", ckpt_every=100,
                          injector=FailureInjector(at_steps=[2]),
                          max_restarts=0)
    with pytest.raises(RuntimeError, match="restart budget"):
        ctl.run(state, data_fn, n_steps=5)


def test_straggler_detection():
    s = StragglerStats(beta=0.5)
    assert not s.observe(0, 1.0, factor=3.0)   # primes the EMA
    assert not s.observe(1, 1.1, factor=3.0)
    assert s.observe(2, 10.0, factor=3.0)      # 10x the EMA -> straggler
    assert s.events and s.events[0]["step"] == 2


def test_straggler_hook_called(tmp_path):
    state, step, data_fn = _setup()
    seen = []
    ctl = TrainController(step, tmp_path / "d", ckpt_every=100,
                          straggler_factor=0.0,  # everything is "slow"
                          on_straggler=lambda s, dt: seen.append(s))
    ctl.run(state, data_fn, n_steps=3)
    assert seen  # hook fired
