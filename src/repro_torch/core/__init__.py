"""Neuron Chunking core of the port: selection, latency model, simulator,
and the per-matrix planner."""
from .api import NeuronChunkingPlanner, SparsePlan
from .baselines import (
    bundled_latency,
    calibrate_threshold,
    threshold_mask,
    topk_mask,
    topk_mask_np,
    unbundled_latency,
)
from .chunking import (
    BatchedChunkSelector,
    ChunkConfig,
    ChunkSelector,
    chunk_table_from_mask,
    greedy_select,
    greedy_select_plain,
    select_chunks_np,
)
from .contiguity import (
    Chunk,
    chunk_stats_np,
    chunks_to_mask_np,
    average_chunk_size,
    contiguity_distribution_np,
    contiguity_histogram,
    mask_run_sizes,
    mask_to_chunks_np,
    mask_to_runs,
    resident_rows_in_windows,
    runs_to_padded_table_np,
)
from .importance import coefficient_of_variation, importance, importance_np, retention
from .latency_model import (
    JETSON_AGX,
    JETSON_NANO,
    DeviceProfile,
    LatencyTable,
    get_profile,
    profile_table,
    row_stream_bytes,
)
from .offload import (
    ComputeModel,
    FlashOffloadSimulator,
    IOEvent,
    decode_site_shapes,
    normalize_site_sparsity,
)
from .pipeline import PipelineModel, PipelineTimeline, overlap_efficiency
from .reorder import (
    Reordering,
    activation_frequency,
    coactivation_reordering,
    hot_cold_reordering,
)
from .sparsity_alloc import LayerProfile, allocate_sparsity, budgets_from_sparsity
