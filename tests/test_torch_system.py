"""End to end on the CPU (twin of ``tests/test_system.py``): a reduced
qwen2-7b learns the synthetic stream through the port's data pipeline,
train step (2 microbatches), controller, checkpoints and one injected
failure, then the port's ServeEngine predicts the stream's permutation
greedily.  And ``examples/torch_train_lm.py`` runs its smoke preset."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_train import models
from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.serve import ServeEngine
from repro_torch.train.fault_tolerance import FailureInjector, TrainController
from repro_torch.train.optim import OptConfig, init_opt_state
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ROOT = Path(__file__).resolve().parent.parent


def test_end_to_end_learns(tmp_path):
    _, _, cfg, params = models("qwen2-7b", "bfloat16")
    opt_cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                        weight_decay=0.01)
    step = make_train_step(cfg, opt_cfg, microbatches=2)
    data = SyntheticLM(cfg.vocab_size, batch=8, seq_len=64, seed=0,
                       correlation=1.0)

    def data_fn(i):
        return {k: torch.from_numpy(v) for k, v in data(i).items()}

    ctl = TrainController(step, tmp_path / "ck", ckpt_every=20,
                          injector=FailureInjector(at_steps=[30]))
    state = (params, init_opt_state(params))
    state, log = ctl.run(state, data_fn, n_steps=60)

    losses = [e["loss"] for e in log if "loss" in e]
    first = float(np.mean(losses[:5]))
    last = float(np.mean(losses[-5:]))
    assert ctl.restarts == 1                    # failure happened + recovered
    assert last < first - 1.0, (first, last)    # actually learned

    eng = ServeEngine(cfg, state[0], max_len=96, device="cpu")
    prompt = data(999)["tokens"][:2, :16]
    res = eng.generate(prompt, n_steps=8)
    acc = float((res.tokens[:, 0] == data._perm[prompt[:, -1]]).mean())
    assert acc >= 0.5, acc                      # >> 1/512 chance level


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", ROOT / "examples" / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_smoke_preset_trains_and_resumes(tmp_path, capsys):
    ex = _example()
    ck = str(tmp_path / "ck")
    ex.main(["--preset", "smoke", "--steps", "4", "--ckpt-every", "2",
             "--inject-failure", "3", "--device", "cpu", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "trained 5 steps" in out and "restarts=1" in out
    _, state, log, ctl, _ = ex.train("smoke", steps=6, ckpt_dir=ck,
                                     resume=True, device="cpu")
    assert [e["step"] for e in log] == [4, 5]
    assert int(state[1]["step"]) == 6
    assert ctl.restarts == 0


def test_example_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example().train("smoke", steps=1)
