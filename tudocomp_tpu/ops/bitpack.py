"""Device-side bit packing: (value, nbits) token arrays -> u32 word arena.

This is the device twin of the host BitWriter pack path (io/bitio.py), the
kernel every entropy back-end funnels into (SURVEY.md §7 step 3): per-token
exclusive prefix sum of widths, then each token scatters its bits into at
most two u32 words. Contributions within a word touch disjoint bit ranges,
so scatter-ADD equals scatter-OR and XLA's native scatter handles it.

Bit order matches the reference exactly (include/tudocomp/io/BitOStream.hpp:
79-88, MSB-first): flat bit position p lives in word p>>5 at u32 bit
31-(p&31); serializing words big-endian yields the reference byte stream.

Tokens are limited to 32 bits here; wider codes are pre-split by the caller
(two tokens). `pack_padded` handles per-block token counts for the
block-parallel pipeline (invalid tail tokens contribute zero bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["pack_tokens", "pack_padded", "words_to_bytes", "finalize_stream"]


def _mask_values(values: jnp.ndarray, nbits: jnp.ndarray) -> jnp.ndarray:
    """Zero bits above each token's declared width."""
    nbits = nbits.astype(jnp.uint32)
    full = jnp.uint32(0xFFFFFFFF)
    mask = jnp.where(
        nbits >= 32, full, (jnp.uint32(1) << jnp.minimum(nbits, 31)) - jnp.uint32(1)
    )
    return values.astype(jnp.uint32) & mask


def _shl(v: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """u32 shift-left with out-of-range shifts yielding 0."""
    s = s.astype(jnp.uint32)
    ok = s < 32
    return jnp.where(ok, v << jnp.minimum(s, 31), jnp.uint32(0))


def _shr(v: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    s = s.astype(jnp.uint32)
    ok = s < 32
    return jnp.where(ok, v >> jnp.minimum(s, 31), jnp.uint32(0))


def pack_tokens(values: jnp.ndarray, nbits: jnp.ndarray, n_words: int):
    """Pack token arrays into a u32 word arena.

    Args:
      values: [n] token values (any int dtype; masked to nbits).
      nbits:  [n] token widths in [0, 32]. Zero-width tokens are skipped.
      n_words: static arena size; bits beyond it are dropped (mode='drop').

    Returns: (words [n_words] u32, total_bits scalar i32).
    """
    nbits = nbits.astype(jnp.int32)
    vals = _mask_values(values, nbits)
    ends = jnp.cumsum(nbits)  # inclusive prefix sum
    offs = ends - nbits  # exclusive start bit
    total_bits = ends[-1] if ends.shape[0] else jnp.int32(0)

    w0 = (offs >> 5).astype(jnp.int32)
    sh_end = (offs & 31) + nbits  # token end within 64-bit window, (0, 63]
    hi = _shl(vals, 32 - sh_end)  # sh_end <= 32 case
    hi = jnp.where(sh_end <= 32, hi, _shr(vals, sh_end - 32))
    lo = jnp.where(sh_end > 32, _shl(vals, 64 - sh_end), jnp.uint32(0))
    live = nbits > 0
    hi = jnp.where(live, hi, jnp.uint32(0))
    lo = jnp.where(live, lo, jnp.uint32(0))

    words = jnp.zeros(n_words, dtype=jnp.uint32)
    words = words.at[w0].add(hi, mode="drop")
    words = words.at[w0 + 1].add(lo, mode="drop")
    return words, total_bits


def pack_padded(values: jnp.ndarray, nbits: jnp.ndarray, n_tokens, n_words: int):
    """pack_tokens with a dynamic valid-token count (padded tails).

    Tokens at index >= n_tokens get width 0 and vanish.
    """
    idx = jnp.arange(values.shape[0], dtype=jnp.int32)
    nbits = jnp.where(idx < n_tokens, nbits.astype(jnp.int32), 0)
    return pack_tokens(values, nbits, n_words)


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize a u32 arena (host) to the payload byte string (no EOF byte)."""
    n_bytes = (int(total_bits) + 7) // 8
    return (
        np.asarray(words, dtype=np.uint32)
        .astype(">u4")
        .tobytes()[:n_bytes]
    )


def finalize_stream(words: np.ndarray, total_bits: int) -> bytes:
    """Serialize with the tudocomp EOF convention (BitOStream.hpp:53-64)."""
    payload = bytearray(words_to_bytes(words, total_bits))
    rem = int(total_bits) % 8
    if 1 <= rem <= 5:
        payload[-1] |= rem
        return bytes(payload)
    if rem >= 6:
        return bytes(payload) + bytes([rem])
    return bytes(payload) + b"\x00"
