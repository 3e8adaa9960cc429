"""Operations and bytes of one ``paged_decode_attention`` call: one
query row per slot, B slots of H heads over KV cached heads, slot b
attending its ``kv_len[b]`` rows through the block table.

Each live cached row (K and V) read once, each query row read and each
output row written once, the block table read once; 4 H head_dim
operations a (query, key) pair.  Idle slots attend their one null row,
as the kernel is given them.
"""

from __future__ import annotations

from typing import Sequence

KERNELS = r"(?<![\w])(mma|fma)_split_kernel\b"
ELEM = 2


def flops(H: int, hd: int, kv_len: Sequence[int]) -> float:
    return 4.0 * H * hd * sum(kv_len)


def nbytes(H: int, KV: int, hd: int, kv_len: Sequence[int],
           table_entries: int) -> float:
    B = len(kv_len)
    return float(ELEM * (2 * KV * hd * sum(kv_len) + 2 * B * H * hd)
                 + 4 * table_entries)
