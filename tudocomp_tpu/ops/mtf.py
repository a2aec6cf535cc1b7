"""Move-to-front transform: data-parallel formulation.

The MTF rank admits a closed form that removes the sequential table:
  - rank(i) for a previously-seen char c = #{distinct chars d whose last
    occurrence before i is later than c's last occurrence before i}
  - rank(i) for a never-seen char c = (#distinct seen chars) + c -
    (#distinct seen chars with value < c)
(derivation: the table is the seen chars ordered by recency followed by the
unseen chars in identity order; matches mtf_encode_char,
compressors/MTFCompressor.hpp:17-29).

This turns MTF encode into last-occurrence cummax + rank reductions over a
[block, 256] matrix — O(n*sigma) elementwise work, tiled to stay in cache. The
host version below (numpy) and the device version (tudocomp_tpu.ops.device)
share this formulation. Decode is inherently sequential (table state); the
host decoder uses a list-based exact simulation.
"""

from __future__ import annotations

import numpy as np

_SIGMA = 256
_BLOCK = 1 << 15


def mtf_encode_host(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    n = len(data)
    if n == 0:
        return data
    out = np.empty(n, dtype=np.uint8)
    carry = np.full(_SIGMA, -1, dtype=np.int64)  # last occurrence so far
    col = np.arange(_SIGMA, dtype=np.int64)
    for start in range(0, n, _BLOCK):
        block = data[start : start + _BLOCK]
        b = len(block)
        rows = np.arange(b, dtype=np.int64)
        M = np.full((b, _SIGMA), -1, dtype=np.int64)
        M[rows, block] = rows + start
        np.maximum.accumulate(M, axis=0, out=M)
        # L[i] = last occurrence strictly before i (exclusive)
        L = np.empty_like(M)
        L[0] = carry
        np.maximum(M[:-1], carry[None, :], out=L[1:])
        carry = np.maximum(M[-1], carry)
        prev = L[rows, block]
        seen = prev >= 0
        # rank for seen chars: # distinct d with later last occurrence
        cnt_gt = (L > prev[:, None]).sum(axis=1)
        # rank for unseen: nseen + c - #(seen with value < c)
        seen_mask = L >= 0
        nseen = seen_mask.sum(axis=1)
        seen_less = np.cumsum(seen_mask, axis=1) - seen_mask
        out[start : start + b] = np.where(
            seen, cnt_gt, nseen + block - seen_less[rows, block]
        ).astype(np.uint8)
    return out


def mtf_decode_host(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    table = list(range(_SIGMA))
    out = np.empty(len(data), dtype=np.uint8)
    for i, v in enumerate(data):
        c = table.pop(v)
        table.insert(0, c)
        out[i] = c
    return out
