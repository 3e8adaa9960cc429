"""Operations and bytes of one ``moe_gmm`` call: x (E, R, K) by the
expert weights (E, K, N).

Counted over the rows that hold an assignment, not the slot buffer's
padding: 2 K N operations a row, each such row read and its output row
written once, and the weights of each expert with at least one row
read once.  ``rows[e]`` is expert e's assigned rows in the call.
"""

from __future__ import annotations

from typing import Sequence

KERNELS = r"(?<![\w])gmm_(ring_)?kernel\b"      # the kernel's CUDA functions
ELEM = 2


def flops(K: int, N: int, rows: Sequence[int]) -> float:
    return 2.0 * K * N * sum(rows)


def nbytes(K: int, N: int, rows: Sequence[int]) -> float:
    hit = sum(1 for r in rows if r > 0)
    return float(ELEM * (hit * K * N + sum(rows) * (K + N)))
