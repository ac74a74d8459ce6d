"""Host-side (numpy-only) page digest — the dedup handshake fallback.

The write path fingerprints pages before shipping them so the dedup
index can match equal-content pages already stored by someone else
(see ``core/dedup_index.py``).  On TPU the checkpoint layer computes
digests with the ``page_digest`` Pallas kernel and passes them through
``BlobClient.write_many(..., digests=...)`` — no double hashing.  Plain
blob writers (scenario clients, the data pipeline) have raw ``bytes``
buffers and no device in the loop, so they need the same fingerprint
computed on the host without touching jax at all.  That is this module.

The math and padding are bit-identical to the kernel path:

* bytes are zero-padded to a whole number of ``page_bytes`` pages and
  each page to a multiple of ``DIGEST_BLOCK_WORDS`` 32-bit words
  (mirroring ``ops.as_page_words``);
* ``digest[m] = sum_i (x_i + SALT) * A_m^(W-1-i)  mod 2^32`` for two
  independent odd multipliers ``A_m`` (mirroring
  ``ref.ref_page_digest``); the accumulation runs in uint64 — since
  2^32 divides 2^64, wraparound mod 2^64 preserves the mod-2^32 result.

``ref.py`` and the Pallas kernel import the constants from here so all
three implementations share one definition.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

# Digest constants: two independent odd multipliers (Knuth & xxHash primes)
# and an additive salt so zero pages don't hash to zero.
DIGEST_MULTS = (2654435761, 2246822519)
DIGEST_SALT = 0x9E3779B9

# Must match ``ops.DIGEST_BLOCK_WORDS`` (kept literal here so this module
# never imports jax-touching code).
DIGEST_BLOCK_WORDS = 512


def digest_weights(n_words: int) -> np.ndarray:
    """Polynomial weights ``A_m^(n_words-1-i) mod 2^32`` as (2, n_words) u32."""
    out = np.empty((2, n_words), dtype=np.uint32)
    for m, mult in enumerate(DIGEST_MULTS):
        w = np.empty(n_words, dtype=np.uint64)
        acc = np.uint64(1)
        for i in range(n_words - 1, -1, -1):
            w[i] = acc
            acc = (acc * np.uint64(mult)) & np.uint64(0xFFFFFFFF)
        out[m] = w.astype(np.uint32)
    return out


@functools.lru_cache(maxsize=8)
def _weights_u64(n_words: int) -> np.ndarray:
    return digest_weights(n_words).astype(np.uint64)


def _padded_words(payload: bytes, page_bytes: int) -> np.ndarray:
    """One page of ``payload`` as padded u32 words (``as_page_words`` domain)."""
    assert page_bytes % 4 == 0
    assert len(payload) <= page_bytes
    n_words = page_bytes // 4
    n_words += (-n_words) % DIGEST_BLOCK_WORDS
    buf = np.zeros(n_words * 4, dtype=np.uint8)
    buf[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return buf.view("<u4")


def host_page_digest(payload: bytes, page_bytes: int) -> Tuple[int, int]:
    """Fingerprint one page's payload as two ints, kernel-compatible.

    ``payload`` may be shorter than ``page_bytes`` (tail page); it is
    zero-padded exactly like the device path pads, so a host digest and
    a kernel digest of the same logical page always agree.
    """
    x = _padded_words(payload, page_bytes).astype(np.uint64) + np.uint64(DIGEST_SALT)
    w = _weights_u64(x.shape[0])
    with np.errstate(over="ignore"):
        d = (x[None, :] * w).sum(axis=1) & np.uint64(0xFFFFFFFF)
    return int(d[0]), int(d[1])
