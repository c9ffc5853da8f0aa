from .pipeline import DataConfig, lm_batches
from .tokenizer import BOS, EOS, PAD, ByteTokenizer

__all__ = ["BOS", "EOS", "PAD", "ByteTokenizer", "DataConfig", "lm_batches"]
