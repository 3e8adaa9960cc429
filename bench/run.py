"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the program under test is the
checkout's ``src/repro_torch``; the cells, configurations, traffic
mixes and metrics are ``BENCHMARK.json`` and the files under ``bench/``.
The last line of standard output is the result (JSON); the numbers the
output check compared, each beside its limit, are the last lines of
standard error.  Exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for), or when a module of JAX or of
the JAX package ``repro`` was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache the program or torch writes stays in the checkout, at a
# fixed path, so that only a cell's first run there builds anything
CACHE = ROOT / "bench" / ".cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from h100bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
