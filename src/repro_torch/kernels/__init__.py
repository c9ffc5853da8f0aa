"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and plain PyTorch versions, and the decode execution backends."""
from .backend import BACKENDS, ExecutionBackend, blocked_masked_matmul, pick_tile, validate_backend
from .chunk_gather_dma import (
    chunk_gather_matmul_dma,
    chunk_gather_matmul_plain,
    chunk_gather_mlp_dma,
    chunk_gather_mlp_plain,
    masks_to_block_tables,
)
from .quantize import dequantize_rows, quantize_params, quantize_rows
