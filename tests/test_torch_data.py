"""The port's synthetic data pipeline: bit for bit the reference's
batches, the twins of ``tests/test_data.py``, and the prefetch."""

import numpy as np
import pytest
import torch

from _torch_train import one_torch_thread  # noqa: F401 (fixture)
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro_torch.data.pipeline import SyntheticLM, prefetch_to_device

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("vocab,batch,seq,seed,corr,step", [
    (512, 4, 32, 0, 0.8, 0), (512, 4, 32, 9, 0.8, 17),
    (2048, 8, 128, 0, 0.9, 3), (152064, 2, 64, 0, 0.9, 0),
    (100, 3, 7, 123, 1.0, 999)])
def test_batches_equal_the_reference_bit_for_bit(vocab, batch, seq, seed,
                                                 corr, step):
    got = SyntheticLM(vocab, batch=batch, seq_len=seq, seed=seed,
                      correlation=corr)(step)
    want = JaxSyntheticLM(vocab, batch=batch, seq_len=seq, seed=seed,
                          correlation=corr)(step)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_deterministic_by_step():
    d1 = SyntheticLM(512, batch=4, seq_len=32, seed=9)
    d2 = SyntheticLM(512, batch=4, seq_len=32, seed=9)
    b1, b2 = d1(17), d2(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_steps_differ():
    d = SyntheticLM(512, batch=4, seq_len=32, seed=9)
    assert not np.array_equal(d(0)["tokens"], d(1)["tokens"])


def test_labels_are_shifted_tokens():
    d = SyntheticLM(512, batch=2, seq_len=16, seed=0)
    b = d(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_correlation_structure():
    """With correlation=1.0 the next token is a fixed permutation of the
    current one: a model can learn this stream."""
    d = SyntheticLM(128, batch=8, seq_len=64, seed=3, correlation=1.0)
    b = d(0)
    assert (b["labels"] == d._perm[b["tokens"]]).mean() == 1.0


def test_tokens_in_range():
    b = SyntheticLM(100, batch=4, seq_len=32, seed=1)(5)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 100


def test_iterate_walks_the_steps():
    d = SyntheticLM(64, batch=2, seq_len=8, seed=0)
    it = d.iterate(start=3)
    for step in (3, 4, 5):
        np.testing.assert_array_equal(next(it)["tokens"], d(step)["tokens"])


def test_prefetch_yields_all_in_order_as_tensors():
    d = SyntheticLM(64, batch=2, seq_len=8, seed=0)
    got = list(prefetch_to_device((d(i) for i in range(5)), size=2,
                                  device="cpu"))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert b["tokens"].device.type == "cpu"
        assert b["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(b["tokens"].numpy(), d(i)["tokens"])
        np.testing.assert_array_equal(b["labels"].numpy(), d(i)["labels"])


def test_prefetch_raises_what_the_source_raised():
    d = SyntheticLM(64, batch=2, seq_len=8, seed=0)

    def source():
        yield d(0)
        raise KeyError("source failed")

    it = prefetch_to_device(source(), device="cpu")
    np.testing.assert_array_equal(next(it)["tokens"].numpy(), d(0)["tokens"])
    with pytest.raises(KeyError, match="source failed"):
        next(it)
