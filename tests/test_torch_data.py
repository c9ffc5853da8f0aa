"""The port's data pipeline and tokenizer against the JAX reference's
(``repro.data``): the tokenizer's round trip and specials, and
``lm_batches`` byte-equal to the reference's — the same draws in the same
order — for a text LM, an early-fusion VLM (frontend embeddings), the
encoder-decoder (its encoder frames) and a streamed text file, over three
batches each. Both pipelines are numpy only, so equality is exact."""
import itertools

import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.data import ByteTokenizer as JTok
from repro.data import DataConfig as JData
from repro.data import lm_batches as jbatches
from repro.data.tokenizer import BOS as JBOS
from repro.data.tokenizer import EOS as JEOS
from repro.data.tokenizer import PAD as JPAD
from repro_torch.configs import get_config as tget
from repro_torch.data import BOS, EOS, PAD, ByteTokenizer, DataConfig, lm_batches

N_BATCHES = 3


def test_tokenizer_round_trip_matches_reference():
    text = "VLM in a flash ✓"
    tok, jtok = ByteTokenizer(), JTok()
    ids = tok.encode(text, add_bos=True, add_eos=True)
    assert ids == jtok.encode(text, add_bos=True, add_eos=True)
    assert ids[0] == BOS == 256 and ids[-1] == EOS == 257
    assert tok.decode(ids) == jtok.decode(ids) == text
    assert tok.encode(text, add_bos=False) == jtok.encode(text, add_bos=False)
    assert (BOS, EOS, PAD, ByteTokenizer.vocab_size) == (JBOS, JEOS, JPAD, JTok.vocab_size)


def _same_batches(arch, reduced, **data):
    jcfg, tcfg = jget(arch), tget(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    want = list(itertools.islice(jbatches(jcfg, JData(**data)), N_BATCHES))
    got = list(itertools.islice(lm_batches(tcfg, DataConfig(**data)), N_BATCHES))
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype and g[key].shape == w[key].shape
            assert g[key].tobytes() == w[key].tobytes(), key
    return got


def test_text_lm_batches_byte_equal():
    got = _same_batches("tinyllama-1.1b", True, batch=4, seq_len=32, seed=1)
    assert got[0]["tokens"].shape == (4, 32) and "frontend" not in got[0]
    assert not np.array_equal(got[0]["tokens"], got[1]["tokens"])


@pytest.mark.parametrize("reduced", (True, False), ids=("reduced", "full"))
def test_vlm_batches_byte_equal(reduced):
    """n_front = min(frontend_tokens, seq_len // 2): the reduced config's
    16 frontend tokens, and at full width half of the sequence."""
    seq = 64
    got = _same_batches("internvl2-76b", reduced, batch=2, seq_len=seq, seed=5)
    cfg = tget("internvl2-76b").reduced() if reduced else tget("internvl2-76b")
    n_front = min(cfg.frontend_tokens, seq // 2)
    assert got[0]["frontend"].shape == (2, n_front, cfg.d_frontend)
    assert got[0]["tokens"].shape == (2, seq - n_front)


def test_encoder_decoder_batches_byte_equal():
    """Whisper: seq_len tokens and frontend_tokens encoder frames."""
    cfg = tget("whisper-small").reduced()
    got = _same_batches("whisper-small", True, batch=2, seq_len=24, seed=2)
    assert got[0]["tokens"].shape == (2, 24)
    assert got[0]["frontend"].shape == (2, cfg.frontend_tokens, cfg.d_frontend)


def test_text_file_batches_byte_equal(tmp_path):
    path = tmp_path / "corpus.txt"
    path.write_text("neuron chunks stream from flash ✓ " * 7)
    got = _same_batches("tinyllama-1.1b", True, batch=2, seq_len=40, seed=0,
                        text_path=str(path))
    assert got[0]["tokens"].max() < 256
