"""Byte-level tokenizer (the port's copy of ``repro.data.tokenizer``; no
vocabulary files).

Token ids 0..255 are raw bytes; ids ≥ 256 are specials. Models with larger
vocabularies leave the tail unused.
"""
from __future__ import annotations

from typing import List

BOS = 256
EOS = 257
PAD = 258
N_SPECIAL = 3


class ByteTokenizer:
    vocab_size = 256 + N_SPECIAL

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        body = bytes(i for i in ids if 0 <= int(i) < 256)
        return body.decode("utf-8", errors="replace")
