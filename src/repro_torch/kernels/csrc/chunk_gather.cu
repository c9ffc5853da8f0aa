// Chunk-gather kernels for sm_90a: K1 (chunk_gather_matmul_dma) and phase 1
// of K2 (chunk_gather_mlp_dma); K2's phase 2 is K1 with an input row mask.
// K3 (chunk_gather_matmul) and K4 (chunk_gather_swiglu) compute K1's function
// without a mask and K2's phase 1, so they are shells around the same device
// bodies (k1_body, k2_gate_up_body) with the ring at depth 1: the BlockSpec
// pipeline of the Pallas versions double-buffers, one block in flight while
// the last one is contracted.
//
// Replaces repro/kernels/chunk_gather_dma.py::chunk_gather_matmul_dma
// (_matmul_dma_kernel) and ::chunk_gather_mlp_dma (_mlp_dma_kernel),
// repro/kernels/chunk_gather_matmul.py::chunk_gather_matmul (_kernel) and
// repro/kernels/chunk_gather_swiglu.py::chunk_gather_swiglu (_kernel).
//
// Bound on the H100: bytes. A decode GEMV at batch <= 8 does 2*B flops per
// weight element it loads, far below the card's flops/byte ridge, so the
// only lever is to read fewer bytes and keep enough of them in flight: only
// the rows of the chunk table are read, as 16-byte cp.async copies of
// (8 x 64)-element tiles, through a ring of DEPTH + 1 shared-memory stages
// (the Pallas kernel's prefetch_depth + 1 VMEM slots) of up to kStageBlocks table
// blocks each, so the next stages' loads are in flight while the current
// stage is contracted.
//
// Exact arithmetic (kept bitwise equal to the plain PyTorch versions): per
// 8-row block, part = sum over the rows, in order, of x*w, each product and
// each sum rounded on its own (__fmul_rn/__fadd_rn, built with -fmad=false);
// acc += part in table order. int8 payloads dequantize as q * scale first.
// The SwiGLU is (g * (1 / (1 + expf(-g)))) * u with an IEEE reciprocal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockRows = 8;
constexpr int kTile = 64;                        // output columns per CTA
constexpr int kThreads = 128;                    // 2 groups x 64 columns
constexpr int kGroups = kThreads / kTile;        // batch rows split over groups
constexpr int kBatchSlab = 8;                    // batch rows per CTA (grid.y)
constexpr int kRowsPerThread = kBatchSlab / kGroups;
constexpr int kStageBlocks = 8;                        // table blocks per ring stage

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Walks a chunk table's active (chunk, block) steps in order, reading the
// CTA's shared-memory copy of the table. Every thread of the CTA runs the
// same walk, so the state stays uniform. off < 0 = done.
struct TableWalk {
  const int* starts;
  const int* sizes;
  int k, bpc, n_rows;
  int ci, bk, off;

  __device__ void seek() {
    while (ci < k) {
      const int size = sizes[ci];
      const int nblk = size > 0 ? min((size + kBlockRows - 1) / kBlockRows, bpc) : 0;
      if (bk < nblk) {
        const int o = starts[ci] + bk * kBlockRows;
        if (o >= 0 && o + kBlockRows <= n_rows) {
          off = o;
          return;
        }
        ++bk;  // a block outside [0, N) is skipped like a padded one
        continue;
      }
      ++ci;
      bk = 0;
    }
    off = -1;
  }
  __device__ void begin() {
    ci = 0;
    bk = 0;
    seek();
  }
  __device__ void next() {
    ++bk;
    seek();
  }
};

// The ring in dynamic shared memory: NS stages, each holding up to
// kStageBlocks consecutive table blocks — per block the (8 x kTile) tiles of
// NMAT matrices, the block's 8 input values of each batch row of the slab,
// its 8 input-mask values, its NMAT scales — and the blocks' row offsets and
// count.
template <typename T, int NMAT>
struct Ring {
  static constexpr int kTileElems = kBlockRows * kTile;
  static constexpr int kBlockBytes =
      NMAT * kTileElems * sizeof(T) + (kBatchSlab + 1) * kBlockRows * sizeof(float);

  __host__ __device__ static size_t bytes(int ns) {
    return static_cast<size_t>(ns) * kStageBlocks * (kBlockBytes + NMAT * sizeof(float)) +
           static_cast<size_t>(ns) * (kStageBlocks + 1) * sizeof(int);
  }

  unsigned char* blocks;
  float* scales;
  int* offs;
  int* counts;

  __device__ Ring(unsigned char* smem, int ns)
      : blocks(smem),
        scales(reinterpret_cast<float*>(smem + static_cast<size_t>(ns) * kStageBlocks *
                                                   kBlockBytes)),
        offs(reinterpret_cast<int*>(scales + ns * kStageBlocks * NMAT)),
        counts(offs + ns * kStageBlocks) {}

  __device__ unsigned char* block(int s, int g) {
    return blocks + static_cast<size_t>(s * kStageBlocks + g) * kBlockBytes;
  }
  __device__ T* tile(int s, int g, int m) {
    return reinterpret_cast<T*>(block(s, g)) + m * kTileElems;
  }
  // x[b0 + i, off:off + 8] at [i * 8], then the input mask's 8 values
  __device__ float* xrows(int s, int g) {
    return reinterpret_cast<float*>(block(s, g) + NMAT * kTileElems * sizeof(T));
  }
  __device__ float* scale(int s, int g, int m) { return scales + (s * kStageBlocks + g) * NMAT + m; }
  __device__ int& off(int s, int g) { return offs[s * kStageBlocks + g]; }
};

// Issue one block's cp.async copies: its NMAT weight tiles (16-byte
// copies), the slab's x rows and the input mask (16-byte copies) and its
// scales (4-byte copies).
template <typename T, bool QUANT, int NMAT>
__device__ __forceinline__ void issue_block(Ring<T, NMAT>& ring, int s, int g, int off,
                                            const T* const (&w)[NMAT],
                                            const float* const (&sc)[NMAT], const float* x,
                                            const float* xmask, int n, int col0, int d, int b0,
                                            int b_end) {
  constexpr int kChunk = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int kPerRow = kTile / kChunk;  // copies per tile row
  constexpr int kTileCopies = NMAT * kBlockRows * kPerRow;
  const int x_copies = 2 * (b_end - b0) + (xmask != nullptr ? 2 : 0);
  for (int c = threadIdx.x; c < kTileCopies + x_copies; c += kThreads) {
    if (c < kTileCopies) {
      const int m = c / (kBlockRows * kPerRow);
      const int r = (c / kPerRow) % kBlockRows;
      const int cc = (c % kPerRow) * kChunk;
      if (col0 + cc < d) {
        cp_async16(ring.tile(s, g, m) + r * kTile + cc,
                   w[m] + static_cast<size_t>(off + r) * d + col0 + cc);
      }
    } else {
      const int i = (c - kTileCopies) / 2;  // slab row, or the mask after the rows
      const int half = (c - kTileCopies) % 2 * 4;
      const float* src = (b0 + i < b_end) ? x + static_cast<size_t>(b0 + i) * n + off + half
                                          : xmask + off + half;
      cp_async16(ring.xrows(s, g) + (b0 + i < b_end ? i : kBatchSlab) * kBlockRows + half, src);
    }
  }
  if (QUANT && threadIdx.x >= kThreads - NMAT) {
    const int m = threadIdx.x - (kThreads - NMAT);
    cp_async4(ring.scale(s, g, m), sc[m] + off / kBlockRows);
  }
}

// Fill ring stage s with the walk's next kStageBlocks blocks (fewer at the
// end, none once the walk is done) and commit them as one cp.async group.
template <typename T, bool QUANT, int NMAT>
__device__ __forceinline__ void issue_stage(Ring<T, NMAT>& ring, int s, TableWalk& walk,
                                            const T* const (&w)[NMAT],
                                            const float* const (&sc)[NMAT], const float* x,
                                            const float* xmask, int n, int col0, int d, int b0,
                                            int b_end) {
  int c = 0;
  for (; c < kStageBlocks && walk.off >= 0; ++c) {
    issue_block<T, QUANT, NMAT>(ring, s, c, walk.off, w, sc, x, xmask, n, col0, d, b0, b_end);
    if (threadIdx.x == 0) ring.off(s, c) = walk.off;
    walk.next();
  }
  if (threadIdx.x == 0) ring.counts[s] = c;
  cp_async_commit();
}

// part[i] = exact partial product of one 8-row block for this thread's
// column and batch row grp + i * kGroups; the block's inputs come from the
// stage. The partials of a stage's blocks are independent of each other, so
// they are all formed first and then added into the accumulators in order.
template <typename T, bool QUANT>
__device__ __forceinline__ void block_part(const T* tile, float scale, const float* xrows,
                                           bool masked, int b0, int b_end, int grp,
                                           int col_local, float (&part)[kRowsPerThread]) {
  float wv[kBlockRows];
#pragma unroll
  for (int r = 0; r < kBlockRows; ++r) {
    wv[r] = to_f32(tile[r * kTile + col_local]);
    if (QUANT) wv[r] = __fmul_rn(wv[r], scale);
  }
  const float* mrow = xrows + kBatchSlab * kBlockRows;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (b0 + grp + i * kGroups >= b_end) break;
    const float* xr = xrows + (grp + i * kGroups) * kBlockRows;
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      float xv = xr[r];
      if (masked) xv = __fmul_rn(xv, mrow[r]);
      const float t = __fmul_rn(xv, wv[r]);
      part[i] = (r == 0) ? t : __fadd_rn(part[i], t);
    }
  }
}

// Copy a chunk table into shared memory (starts, then sizes) and return the
// number of entries up to the last non-empty one: the walk stops there
// instead of stepping through the padded tail.
__device__ __forceinline__ int load_table(const int* starts, const int* sizes, int k, int* table) {
  __shared__ int used;
  if (threadIdx.x == 0) used = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < k; i += kThreads) {
    table[i] = __ldg(starts + i);
    const int size = __ldg(sizes + i);
    table[k + i] = size;
    if (size > 0) last = i + 1;
  }
  if (last > 0) atomicMax(&used, last);
  __syncthreads();
  return used;
}

// K1's body: y[b, col] = sum over the table's blocks, in order, of the exact
// block partial. Stage j + DEPTH is in flight while stage j is contracted.
// smem is the launch's dynamic shared memory: the ring, then the table.
template <typename T, int DEPTH>
__device__ __forceinline__ void k1_body(unsigned char* smem, const T* __restrict__ w,
                                        const float* __restrict__ x,
                                        const float* __restrict__ xmask,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ sizes,
                                        const float* __restrict__ scales,
                                        float* __restrict__ y, int batch, int n, int d, int k,
                                        int bpc) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int NS = DEPTH + 1;
  Ring<T, 1> ring(smem, NS);
  const T* const ws[1] = {w};
  const float* const scs[1] = {scales};

  const int col0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kBatchSlab;
  const int b_end = min(b0 + kBatchSlab, batch);
  const int col_local = threadIdx.x % kTile;
  const int grp = threadIdx.x / kTile;
  const int col = col0 + col_local;

  int* table = reinterpret_cast<int*>(smem + Ring<T, 1>::bytes(NS));
  const int used = load_table(starts, sizes, k, table);
  TableWalk walk{table, table + k, used, bpc, n, 0, 0, -1};
  walk.begin();
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    issue_stage<T, QUANT, 1>(ring, s, walk, ws, scs, x, xmask, n, col0, d, b0, b_end);
  }

  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  for (int slot = 0;; slot = (slot + 1) % NS) {
    issue_stage<T, QUANT, 1>(ring, (slot + DEPTH) % NS, walk, ws, scs, x, xmask, n, col0, d, b0,
                             b_end);
    cp_async_wait<DEPTH>();  // this stage's group has landed
    __syncthreads();
    const int count = ring.counts[slot];
    if (count == 0) break;  // the walk ended: every later stage is empty too
    if (col < d) {
      float part[kStageBlocks][kRowsPerThread];
#pragma unroll
      for (int g = 0; g < kStageBlocks; ++g) {
        if (g < count) {
          block_part<T, QUANT>(ring.tile(slot, g, 0), QUANT ? *ring.scale(slot, g, 0) : 1.0f,
                               ring.xrows(slot, g), xmask != nullptr, b0, b_end, grp, col_local,
                               part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kStageBlocks; ++g) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (g < count) acc[i] = __fadd_rn(acc[i], part[g][i]);
        }
      }
    }
    __syncthreads();  // the stage may be refilled next iteration
  }

  if (col < d) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int b = b0 + grp + i * kGroups;
      if (b < b_end) y[static_cast<size_t>(b) * d + col] = acc[i];
    }
  }
}

// K2 phase 1's body: gate and up off the hidden lane, each block streamed
// once into the same stage; h = (g * (1 / (1 + exp(-g)))) * u.
template <typename T, int DEPTH>
__device__ __forceinline__ void k2_gate_up_body(unsigned char* smem, const T* __restrict__ wg,
                                                const T* __restrict__ wu,
                                                const float* __restrict__ x,
                                                const int* __restrict__ starts,
                                                const int* __restrict__ sizes,
                                                const float* __restrict__ sg,
                                                const float* __restrict__ su,
                                                float* __restrict__ h, int batch, int n, int f,
                                                int k, int bpc) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int NS = DEPTH + 1;
  Ring<T, 2> ring(smem, NS);
  const T* const ws[2] = {wg, wu};
  const float* const scs[2] = {sg, su};

  const int col0 = blockIdx.x * kTile;
  const int b0 = blockIdx.y * kBatchSlab;
  const int b_end = min(b0 + kBatchSlab, batch);
  const int col_local = threadIdx.x % kTile;
  const int grp = threadIdx.x / kTile;
  const int col = col0 + col_local;

  int* table = reinterpret_cast<int*>(smem + Ring<T, 2>::bytes(NS));
  const int used = load_table(starts, sizes, k, table);
  TableWalk walk{table, table + k, used, bpc, n, 0, 0, -1};
  walk.begin();
#pragma unroll
  for (int s = 0; s < DEPTH; ++s) {
    issue_stage<T, QUANT, 2>(ring, s, walk, ws, scs, x, nullptr, n, col0, f, b0, b_end);
  }

  float accg[kRowsPerThread], accu[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    accg[i] = 0.0f;
    accu[i] = 0.0f;
  }

  for (int slot = 0;; slot = (slot + 1) % NS) {
    issue_stage<T, QUANT, 2>(ring, (slot + DEPTH) % NS, walk, ws, scs, x, nullptr, n, col0, f,
                             b0, b_end);
    cp_async_wait<DEPTH>();
    __syncthreads();
    const int count = ring.counts[slot];
    if (count == 0) break;
    if (col < f) {
      float pg[kStageBlocks][kRowsPerThread], pu[kStageBlocks][kRowsPerThread];
#pragma unroll
      for (int g = 0; g < kStageBlocks; ++g) {
        if (g < count) {
          block_part<T, QUANT>(ring.tile(slot, g, 0), QUANT ? *ring.scale(slot, g, 0) : 1.0f,
                               ring.xrows(slot, g), false, b0, b_end, grp, col_local, pg[g]);
          block_part<T, QUANT>(ring.tile(slot, g, 1), QUANT ? *ring.scale(slot, g, 1) : 1.0f,
                               ring.xrows(slot, g), false, b0, b_end, grp, col_local, pu[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kStageBlocks; ++g) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (g < count) {
            accg[i] = __fadd_rn(accg[i], pg[g][i]);
            accu[i] = __fadd_rn(accu[i], pu[g][i]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (col < f) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int b = b0 + grp + i * kGroups;
      if (b < b_end) {
        const float g = accg[i];
        const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-g)));
        h[static_cast<size_t>(b) * f + col] = __fmul_rn(__fmul_rn(g, sig), accu[i]);
      }
    }
  }
}

// The kernels: shells around the bodies, one entry function each, so ptxas
// and the profiler name them apart.
template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
    k1_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const float* __restrict__ xmask, const int* __restrict__ starts,
              const int* __restrict__ sizes, const float* __restrict__ scales,
              float* __restrict__ y, int batch, int n, int d, int k, int bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  k1_body<T, DEPTH>(smem, w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc);
}

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads)
    k2_gate_up_kernel(const T* __restrict__ wg, const T* __restrict__ wu,
                      const float* __restrict__ x, const int* __restrict__ starts,
                      const int* __restrict__ sizes, const float* __restrict__ sg,
                      const float* __restrict__ su, float* __restrict__ h, int batch, int n,
                      int f, int k, int bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  k2_gate_up_body<T, DEPTH>(smem, wg, wu, x, starts, sizes, sg, su, h, batch, n, f, k, bpc);
}

// K3: K1 at depth 1 with no input mask (floating-point weights only).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k3_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const int* __restrict__ starts, const int* __restrict__ sizes,
              float* __restrict__ y, int batch, int n, int d, int k, int bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  k1_body<T, 1>(smem, w, x, nullptr, starts, sizes, nullptr, y, batch, n, d, k, bpc);
}

// K4: K2's phase 1 at depth 1 (floating-point weights only).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    k4_kernel(const T* __restrict__ wg, const T* __restrict__ wu, const float* __restrict__ x,
              const int* __restrict__ starts, const int* __restrict__ sizes,
              float* __restrict__ h, int batch, int n, int f, int k, int bpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  k2_gate_up_body<T, 1>(smem, wg, wu, x, starts, sizes, nullptr, nullptr, h, batch, n, f, k,
                        bpc);
}

// Shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

template <typename T, int DEPTH>
int launch_k1_t(const void* w, const float* x, const float* xmask, const int* starts,
                const int* sizes, const float* scales, float* y, int batch, int n, int d,
                int k, int bpc, cudaStream_t stream) {
  const dim3 grid((d + kTile - 1) / kTile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = Ring<T, 1>::bytes(DEPTH + 1) + 2 * sizeof(int) * k;
  if (const int rc = reserve_smem(k1_kernel<T, DEPTH>, smem)) return rc;
  k1_kernel<T, DEPTH><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(w), x, xmask,
                                                        starts, sizes, scales, y, batch, n, d,
                                                        k, bpc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DEPTH>
int launch_k2_t(const void* wg, const void* wu, const float* x, const int* starts,
                const int* sizes, const float* sg, const float* su, float* h, int batch,
                int n, int f, int k, int bpc, cudaStream_t stream) {
  const dim3 grid((f + kTile - 1) / kTile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = Ring<T, 2>::bytes(DEPTH + 1) + 2 * sizeof(int) * k;
  if (const int rc = reserve_smem(k2_gate_up_kernel<T, DEPTH>, smem)) return rc;
  k2_gate_up_kernel<T, DEPTH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(wg), static_cast<const T*>(wu), x, starts, sizes, sg, su, h,
      batch, n, f, k, bpc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k1_depth(int depth, const void* w, const float* x, const float* xmask,
                    const int* starts, const int* sizes, const float* scales, float* y,
                    int batch, int n, int d, int k, int bpc, cudaStream_t st) {
  switch (depth) {
    case 0: return launch_k1_t<T, 0>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, st);
    case 1: return launch_k1_t<T, 1>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, st);
    case 2: return launch_k1_t<T, 2>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, st);
    case 3: return launch_k1_t<T, 3>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_k2_depth(int depth, const void* wg, const void* wu, const float* x,
                    const int* starts, const int* sizes, const float* sg, const float* su,
                    float* h, int batch, int n, int f, int k, int bpc, cudaStream_t st) {
  switch (depth) {
    case 0: return launch_k2_t<T, 0>(wg, wu, x, starts, sizes, sg, su, h, batch, n, f, k, bpc, st);
    case 1: return launch_k2_t<T, 1>(wg, wu, x, starts, sizes, sg, su, h, batch, n, f, k, bpc, st);
    case 2: return launch_k2_t<T, 2>(wg, wu, x, starts, sizes, sg, su, h, batch, n, f, k, bpc, st);
    case 3: return launch_k2_t<T, 3>(wg, wu, x, starts, sizes, sg, su, h, batch, n, f, k, bpc, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_k3_t(const void* w, const float* x, const int* starts, const int* sizes, float* y,
                int batch, int n, int d, int k, int bpc, cudaStream_t stream) {
  const dim3 grid((d + kTile - 1) / kTile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = Ring<T, 1>::bytes(2) + 2 * sizeof(int) * k;
  if (const int rc = reserve_smem(k3_kernel<T>, smem)) return rc;
  k3_kernel<T><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(w), x, starts, sizes, y,
                                                 batch, n, d, k, bpc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k4_t(const void* wg, const void* wu, const float* x, const int* starts,
                const int* sizes, float* h, int batch, int n, int f, int k, int bpc,
                cudaStream_t stream) {
  const dim3 grid((f + kTile - 1) / kTile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = Ring<T, 2>::bytes(2) + 2 * sizeof(int) * k;
  if (const int rc = reserve_smem(k4_kernel<T>, smem)) return rc;
  k4_kernel<T><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(wg),
                                                 static_cast<const T*>(wu), x, starts, sizes, h,
                                                 batch, n, f, k, bpc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wtype: 0 = bf16, 1 = f32, 2 = int8 (then scales is the per-block lane).
extern "C" int k1_chunk_gather_matmul(const void* w, int wtype, const void* x, const void* xmask,
                                      const void* starts, const void* sizes, const void* scales,
                                      void* y, int batch, int n, int d, int k, int bpc, int depth,
                                      void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(xmask);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* sc = static_cast<const float*>(scales);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || d == 0) return 0;
  switch (wtype) {
    case 0: return launch_k1_depth<__nv_bfloat16>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, s);
    case 1: return launch_k1_depth<float>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, s);
    case 2: return launch_k1_depth<int8_t>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int k2_gate_up(const void* wg, const void* wu, int wtype, const void* x,
                          const void* starts, const void* sizes, const void* sg, const void* su,
                          void* h, int batch, int n, int f, int k, int bpc, int depth,
                          void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* g = static_cast<const float*>(sg);
  const auto* u = static_cast<const float*>(su);
  auto* hf = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || f == 0) return 0;
  switch (wtype) {
    case 0: return launch_k2_depth<__nv_bfloat16>(depth, wg, wu, xf, st, sz, g, u, hf, batch, n, f, k, bpc, s);
    case 1: return launch_k2_depth<float>(depth, wg, wu, xf, st, sz, g, u, hf, batch, n, f, k, bpc, s);
    case 2: return launch_k2_depth<int8_t>(depth, wg, wu, xf, st, sz, g, u, hf, batch, n, f, k, bpc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3 and K4 take bf16 (wtype 0) or f32 (wtype 1) weights.
extern "C" int k3_chunk_gather_matmul(const void* w, int wtype, const void* x,
                                      const void* starts, const void* sizes, void* y, int batch,
                                      int n, int d, int k, int bpc, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || d == 0) return 0;
  switch (wtype) {
    case 0: return launch_k3_t<__nv_bfloat16>(w, xf, st, sz, yf, batch, n, d, k, bpc, s);
    case 1: return launch_k3_t<float>(w, xf, st, sz, yf, batch, n, d, k, bpc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int k4_chunk_gather_swiglu(const void* wg, const void* wu, int wtype, const void* x,
                                      const void* starts, const void* sizes, void* h, int batch,
                                      int n, int f, int k, int bpc, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  auto* hf = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || f == 0) return 0;
  switch (wtype) {
    case 0: return launch_k4_t<__nv_bfloat16>(wg, wu, xf, st, sz, hf, batch, n, f, k, bpc, s);
    case 1: return launch_k4_t<float>(wg, wu, xf, st, sz, hf, batch, n, f, k, bpc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
