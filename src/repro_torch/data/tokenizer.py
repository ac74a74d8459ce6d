"""Byte-level tokenizer for the runnable examples.

Vocab: 256 byte values + BOS/EOS/PAD.  Enough to train the e2e example
end to end without external assets; the pipeline is tokenizer-agnostic
(it moves int32 token streams).
"""

from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 256, 257, 258
VOCAB_SIZE = 259


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad, bos, eos = PAD, BOS, EOS

    def encode(self, text: str, add_special: bool = True) -> np.ndarray:
        ids = np.frombuffer(text.encode("utf-8", errors="replace"), dtype=np.uint8)
        ids = ids.astype(np.int32)
        if add_special:
            ids = np.concatenate([[BOS], ids, [EOS]]).astype(np.int32)
        return ids

    def decode(self, ids) -> str:
        ids = [int(i) for i in ids if int(i) < 256]
        return bytes(ids).decode("utf-8", errors="replace")
