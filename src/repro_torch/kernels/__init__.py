"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes wrappers
and plain PyTorch versions, the public ``sparse_*`` wrappers and the decode
execution backends."""
from .backend import BACKENDS, ExecutionBackend, blocked_masked_matmul, pick_tile, validate_backend
from .chunk_gather_dma import (
    chunk_gather_matmul_dma,
    chunk_gather_matmul_plain,
    chunk_gather_mlp_dma,
    chunk_gather_mlp_plain,
    chunk_gather_swiglu_plain,
    masks_to_block_tables,
)
from .chunk_gather_matmul import align_chunk_table, chunk_gather_matmul
from .chunk_gather_swiglu import chunk_gather_swiglu
from .ops import (
    plan_to_kernel_table,
    sparse_matmul,
    sparse_matmul_dma,
    sparse_mlp_fused,
    sparse_swiglu,
)
from .quantize import dequantize_rows, quantize_params, quantize_rows
from .ref import (
    chunk_gather_matmul_ref,
    chunk_gather_mlp_ref,
    chunk_gather_swiglu_ref,
    chunk_table_to_mask,
)
