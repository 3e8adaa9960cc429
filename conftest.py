"""Pytest settings shared by every test directory: the ``cuda`` marker.

Tests of code that runs only on an NVIDIA GPU (the CUDA kernels) carry
``@pytest.mark.cuda`` and skip, with a reason, when no card is present;
the decision is made inside the test, never at import or collection.
Run them on a GPU machine with ``python -m pytest -m cuda tests``.

The folders that ``.gitignore`` lists for copies of the tree and for
what runs bring back are not collected: a checkout unpacked there for a
side-by-side run would otherwise shadow the modules of the repo's own
test files.
"""

collect_ignore = ["_chip", "chiprun_out", "experiments"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (and nvcc) to run; skips "
                   "on machines without one")
