"""Data pipeline (the port's copy of ``repro.data.pipeline``): a seeded
synthetic corpus or a streamed text file, packed into fixed-length LM
batches on the host in numpy; the caller moves them to its device.

The synthetic corpus is an order-1 Markov chain over a small alphabet, so
that a small model has structure to fit. For the VLM and audio archs each
batch also carries frontend embeddings (the stubbed modality input),
correlated with the batch's first tokens. The draws are the reference's,
in its order, so the batches are byte-equal to its batches for the same
config and seed.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, Optional

import numpy as np

from ..configs.base import ModelConfig
from .tokenizer import ByteTokenizer


@dataclasses.dataclass
class DataConfig:
    batch: int
    seq_len: int
    seed: int = 0
    text_path: Optional[str] = None  # stream a real file if given


def _synthetic_stream(rng: np.random.Generator, vocab: int) -> Iterator[int]:
    """An order-1 Markov chain over min(64, vocab) states: a sparse-ish
    transition matrix with a few likely successors each."""
    k = min(64, vocab)
    trans = rng.dirichlet(np.full(k, 0.1), size=k)
    state = 0
    while True:
        state = int(rng.choice(k, p=trans[state]))
        yield state


def _file_stream(path: str, tok: ByteTokenizer) -> Iterator[int]:
    """The file's bytes, over and over."""
    while True:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 16), b""):
                yield from chunk


def lm_batches(cfg: ModelConfig, data: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """Yields {"tokens": (B, S) int32[, "frontend": (B, n, d) f32]} forever.
    A VLM's batch holds n = min(frontend_tokens, seq_len // 2) frontend
    positions and seq_len - n tokens; an encoder-decoder's holds
    frontend_tokens encoder positions and seq_len tokens."""
    rng = np.random.default_rng(data.seed)
    tok = ByteTokenizer()
    stream = (_file_stream(data.text_path, tok) if data.text_path
              else _synthetic_stream(rng, cfg.vocab_size))
    n_front = 0
    if cfg.d_frontend:
        n_front = min(cfg.frontend_tokens, data.seq_len // 2)
    s_text = data.seq_len if cfg.is_encdec else data.seq_len - n_front
    if cfg.is_encdec:
        n_front = cfg.frontend_tokens

    while True:
        toks = np.fromiter(itertools.islice(stream, data.batch * s_text),
                           dtype=np.int32).reshape(data.batch, s_text)
        out: Dict[str, np.ndarray] = {"tokens": toks % cfg.vocab_size}
        if cfg.d_frontend:
            # frontend embeddings correlated with the first tokens of the batch
            base = rng.normal(0, 1, (data.batch, n_front, cfg.d_frontend))
            drift = (toks[:, :1, None] % 17) / 17.0
            out["frontend"] = (base + drift).astype(np.float32)
        yield out
