"""Neuron Chunking core of the port: selection, latency model, simulator."""
from .baselines import topk_mask
from .chunking import (
    BatchedChunkSelector,
    ChunkConfig,
    ChunkSelector,
    greedy_select,
    greedy_select_plain,
    select_chunks_np,
)
from .contiguity import Chunk, mask_run_sizes, mask_to_chunks_np
from .importance import importance
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
