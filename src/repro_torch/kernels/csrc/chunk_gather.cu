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
// weight element it loads, far below the card's ~295 flops/byte ridge, so the
// lever is to read only the table's rows and to keep enough of them in
// flight. No tensor cores: wgmma reassociates the sums, which the bitwise
// contract below forbids, and at this batch the flops are not the bound.
//
// k1_body (K1, K3, K2's phase 2). What bounded its first form was a serial
// chain inside each CTA — a table walk, copy issue and an 8-deep partial
// sum per 8-row block, on 4 warps and 4-32 CTAs — not memory. Now: each CTA
// turns the table into a flat block list once (per-entry counts, a
// block-wide scan); the CTAs each take one 32-byte sector of every weight row
// (16 bf16 columns; 16 bytes for narrow matrices, for twice the CTAs), so the
// grid covers the SMs and every copy fills a sector; the CTA's x rows are
// loaded once, whole, into shared memory (copying them per block and CTA
// made every CTA hammer the same few L2 lines); of 16 warps, all but the
// last one or few form a stage's partials at once, two columns a lane, while
// later stages land (cp.async tracked by an mbarrier per ring slot); the
// last warps own the outputs, one thread each, and add the partials in table
// order — the only serial chain left, one add per block — while the next
// stage's partials are formed.
//
// k2_gate_up_body (K2's phase 1, K4) keeps the first form: the table walk
// (TableWalk), stages of 8 blocks (Ring, issue_block, block_part).
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

// ---------------------------------------------------------------------------
// K1's body (K1, K2's phase 2, K3): a flat block list, narrow column tiles
// spread over the SMs, partials formed in parallel and added in table order.
// ---------------------------------------------------------------------------

constexpr int kK1Threads = 512;              // 16 warps
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1WindowBlocks = 1024;        // block-list entries held at once
constexpr int kK1SlabBytes = 80 * 1024;      // x slab (and mask) held whole up to this size

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// k1_body's dynamic shared memory (mirrored by k1_smem_bytes in
// chunk_gather_dma.py). The slab's x rows (and the input mask) are held
// whole when they fit in kK1SlabBytes: loaded once with coalesced copies,
// they cost the CTA one pass over x. Otherwise each block carries an input
// record of its 8 values per row. NS ring stages, each holding `blocks`
// table blocks: their weight tiles (8 rows x `tile` columns, padded by one
// row so that the lane groups reading neighbouring blocks hit other banks),
// their input records, scales and row offsets. Then the partial buffer (two
// halves of rows x tile outputs x pstride blocks f32: each output's partials
// contiguous, for vector loads in the ordered add, and pstride = 4 mod 32 so
// that the columns a lane group writes fall in different banks), the x slab,
// a window of the flat block list, and the table's per-entry first block
// offset and exclusive prefix.
struct K1Layout {
  int tile, blocks, rows, ns, k, window, xrows, xrec, pstride;
  bool slab;
  size_t tile_bytes, stage_bytes;

  __host__ __device__ K1Layout(int elem, int tile_, int blocks_, int rows_, bool masked, int n,
                               int ns_, int k_)
      : tile(tile_),
        blocks(blocks_),
        rows(rows_),
        ns(ns_),
        k(k_),
        window(blocks_ * (kK1WindowBlocks / blocks_ > 0 ? kK1WindowBlocks / blocks_ : 1)),
        xrows(rows_ + (masked ? 1 : 0)),
        xrec(static_cast<size_t>(xrows) * n * sizeof(float) <= kK1SlabBytes ? 0
                                                                            : xrows * kBlockRows),
        pstride((blocks_ + 31) / 32 * 32 + 4),
        slab(xrec == 0),
        tile_bytes(static_cast<size_t>(kBlockRows + 1) * tile_ * elem),
        stage_bytes(blocks_ * (tile_bytes + xrec * sizeof(float)) +
                    2 * align16(blocks_ * sizeof(int))) {}

  __host__ __device__ size_t xrec_off() const { return blocks * tile_bytes; }
  __host__ __device__ size_t scale_off() const { return xrec_off() + blocks * xrec * sizeof(float); }
  __host__ __device__ size_t offs_off() const { return scale_off() + align16(blocks * sizeof(int)); }
  __host__ __device__ size_t pbuf_off() const { return ns * stage_bytes; }
  __host__ __device__ size_t pbuf_half() const { return static_cast<size_t>(rows) * tile * pstride; }
  __host__ __device__ size_t slab_off() const { return pbuf_off() + 2 * pbuf_half() * sizeof(float); }
  __host__ __device__ size_t slab_floats(int n) const { return slab ? static_cast<size_t>(xrows) * n : 0; }
  __host__ __device__ size_t list_off(int n) const { return slab_off() + slab_floats(n) * sizeof(float); }
  __host__ __device__ size_t base_off(int n) const { return list_off(n) + window * sizeof(int); }
  __host__ __device__ size_t pre_off(int n) const { return base_off(n) + k * sizeof(int); }
  __host__ __device__ size_t bytes(int n) const { return pre_off(n) + (k + 1) * sizeof(int); }
};

// Turn the chunk table into per-entry block counts, once: entry e holds the
// blocks bk in [lo, hi) of its chunk that lie inside [0, N) (padded entries
// and blocks outside the matrix hold none), so base[e] = its first block's
// row offset and pre[e] = the number of blocks before it (a block-wide
// exclusive scan). The first `window` entries of the flat block list are
// written on the way. Returns the table's block count, pre[k].
__device__ __forceinline__ int k1_scan_table(const int* __restrict__ starts,
                                             const int* __restrict__ sizes, int k, int n, int bpc,
                                             int* base, int* pre, int* list, int window) {
  __shared__ int warp_sums[kK1Warps];
  const int per = (k + kK1Threads - 1) / kK1Threads;
  const int e0 = min(k, static_cast<int>(threadIdx.x) * per);
  const int e1 = min(k, e0 + per);
  int local = 0;
  for (int e = e0; e < e1; ++e) {
    const int s = __ldg(starts + e);
    const int size = __ldg(sizes + e);
    const int nblk = size > 0 ? min((size + kBlockRows - 1) / kBlockRows, bpc) : 0;
    const int lo = s < 0 ? (-s + kBlockRows - 1) / kBlockRows : 0;  // s + 8 lo >= 0
    const int room = n - kBlockRows - s;                              // s + 8 bk + 8 <= n
    const int hi = room < 0 ? 0 : min(nblk, room / kBlockRows + 1);
    const int c = max(0, hi - lo);
    base[e] = s + lo * kBlockRows;
    pre[e] = c;
    local += c;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  int run = inc - local, total = 0;
#pragma unroll
  for (int w = 0; w < kK1Warps; ++w) {
    const int v = warp_sums[w];
    if (w < warp) run += v;
    total += v;
  }
  for (int e = e0; e < e1; ++e) {
    const int c = pre[e];
    pre[e] = run;
    for (int j = run; j < min(run + c, window); ++j) list[j] = base[e] + (j - run) * kBlockRows;
    run += c;
  }
  if (threadIdx.x == 0) pre[k] = total;
  __syncthreads();
  return total;
}

// list[j - lo] = row offset of table block j, for j in [lo, lo + window).
__device__ __forceinline__ void k1_fill_window(const int* base, const int* pre, int k, int lo,
                                               int window, int* list) {
  __syncthreads();  // no thread still issues copies from the previous window
  const int hi = lo + window;
  for (int e = threadIdx.x; e < k; e += kK1Threads) {
    const int p0 = pre[e];
    const int p1 = min(pre[e + 1], hi);
    for (int j = max(p0, lo); j < p1; ++j) list[j - lo] = base[e] + (j - p0) * kBlockRows;
  }
  __syncthreads();
}

// mbarrier operations: a stage's mbarrier completes when every thread's
// cp.async copies of that stage have landed (cp.async.mbarrier.arrive).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// One bulk asynchronous copy (global -> shared, through the tensor memory
// accelerator), counted in bytes on an mbarrier: for long contiguous runs.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Issue this thread's share of one stage's copies — `count` blocks from
// list entry `first` on: the weight tiles' row segments (16-byte cp.async,
// neighbouring threads on neighbouring segments), the input records when x
// is not held whole (each block's 8 values per slab row and of the mask, two
// copies each) and the int8 scales (4 bytes) — note the blocks' row offsets,
// and arrive on the stage's mbarrier once the copies land.
template <typename T, bool QUANT>
__device__ __forceinline__ void k1_issue_stage(const K1Layout& L, unsigned char* stage,
                                               uint64_t* bar, int first, int count,
                                               const int* list, const T* w, const float* sc,
                                               const float* x, const float* xmask, int n, int d,
                                               int col0, int b0, int rows) {
  constexpr int kChunk = 16 / sizeof(T);              // elements per 16-byte copy
  const int seg_shift = __ffs(L.tile / kChunk) - 1;   // log2(copies per tile row)
  const int seg_mask = (1 << seg_shift) - 1;
  for (int c = threadIdx.x; c < (count * kBlockRows) << seg_shift; c += kK1Threads) {
    const int row = c >> seg_shift;  // block row / 8, its row row % 8
    const int cc = (c & seg_mask) * kChunk;
    if (col0 + cc < d) {
      cp_async16(stage + (row >> 3) * L.tile_bytes + ((row & 7) * L.tile + cc) * sizeof(T),
                 w + static_cast<size_t>(list[first + (row >> 3)] + (row & 7)) * d + col0 + cc);
    }
  }
  if (!L.slab) {
    const int xrows = rows + (xmask != nullptr ? 1 : 0);
    float* xr = reinterpret_cast<float*>(stage + L.xrec_off());
    for (int c = threadIdx.x; c < count * xrows * 2; c += kK1Threads) {
      const int g = c / (2 * xrows);
      const int i = (c >> 1) - g * xrows;  // slab row, or the mask after the rows
      const int off = list[first + g] + (c & 1) * 4;
      cp_async16(xr + g * L.xrec + i * kBlockRows + (c & 1) * 4,
                 i < rows ? x + static_cast<size_t>(b0 + i) * n + off : xmask + off);
    }
  }
  if (QUANT) {
    float* scs = reinterpret_cast<float*>(stage + L.scale_off());
    for (int g = threadIdx.x; g < count; g += kK1Threads) {
      cp_async4(scs + g, sc + list[first + g] / kBlockRows);
    }
  }
  int* offs = reinterpret_cast<int*>(stage + L.offs_off());
  for (int g = threadIdx.x; g < count; g += kK1Threads) offs[g] = list[first + g];
  mbar_arrive_on_copies(bar);
}

// The CTA's x rows and the input mask, whole: one bulk copy per row, issued
// by one thread, landing on their own mbarrier.
__device__ __forceinline__ void k1_load_slab(float* slab, uint64_t* bar, const float* x,
                                             const float* xmask, int n, int b0, int rows) {
  const int xrows = rows + (xmask != nullptr ? 1 : 0);
  const unsigned row_bytes = static_cast<unsigned>(n * sizeof(float));
  mbar_expect_tx(bar, xrows * row_bytes);
  for (int i = 0; i < xrows; ++i) {
    bulk_copy(slab + static_cast<size_t>(i) * n,
              i < rows ? x + static_cast<size_t>(b0 + i) * n : xmask, row_bytes, bar);
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kBlockRows]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// A lane's P neighbouring columns of one tile row, as f32 (P = 2 for bf16
// and int8: one 4- or 2-byte load; 1 for f32).
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, float (&v)[2]) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(h);
  v[1] = __high2float(h);
}
__device__ __forceinline__ void load_cols(const int8_t* p, float (&v)[2]) {
  const char2 q = *reinterpret_cast<const char2*>(p);
  v[0] = static_cast<float>(q.x);
  v[1] = static_cast<float>(q.y);
}
__device__ __forceinline__ void load_cols(const float* p, float (&v)[1]) { v[0] = *p; }

// The exact partials of one landed stage, formed by the CTA's first `warps`
// warps: a block's `tile` columns go to tile / P lanes, P neighbouring
// columns each, so a warp works on 32 * P / tile blocks at once, and the
// CTA's lane groups take blocks q, q + step, ... A block's inputs are its 8
// values of each slab row (and of the mask) — at stride n in the x slab, or
// 8 in its input record. For each slab row and column, part = the block's 8
// products summed in row order, each rounded on its own; rows and columns
// are independent chains.
template <typename T, bool QUANT>
__device__ __forceinline__ void k1_form_parts(const K1Layout& L, const unsigned char* stage,
                                              int count, int rows, bool masked,
                                              const float* slab, int n, int warps,
                                              float* pbuf) {
  constexpr int P = sizeof(T) == 4 ? 1 : 2;
  const int lane = threadIdx.x & 31;
  const int group = L.tile / P;  // lanes per block
  const int nsub = 32 / group;
  const int c = (lane % group) * P;
  const float* xr = reinterpret_cast<const float*>(stage + L.xrec_off());
  const float* scs = reinterpret_cast<const float*>(stage + L.scale_off());
  const int* offs = reinterpret_cast<const int*>(stage + L.offs_off());
  const int stride = L.slab ? n : kBlockRows;
  for (int g = (threadIdx.x >> 5) * nsub + lane / group; g < count; g += warps * nsub) {
    const T* tile = reinterpret_cast<const T*>(stage + g * L.tile_bytes) + c;
    float wv[kBlockRows][P];
#pragma unroll
    for (int r = 0; r < kBlockRows; ++r) {
      load_cols(tile + r * L.tile, wv[r]);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (QUANT) wv[r][p] = __fmul_rn(wv[r][p], scs[g]);
      }
    }
    const float* xb = L.slab ? slab + offs[g] : xr + g * L.xrec;
    float mv[kBlockRows];
    if (masked) load8(xb + rows * stride, mv);
#pragma unroll
    for (int i = 0; i < kBatchSlab; ++i) {
      if (i < rows) {
        float xv[kBlockRows];
        load8(xb + i * stride, xv);
        if (masked) {
#pragma unroll
          for (int r = 0; r < kBlockRows; ++r) xv[r] = __fmul_rn(xv[r], mv[r]);
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float part = __fmul_rn(xv[0], wv[0][p]);
#pragma unroll
          for (int r = 1; r < kBlockRows; ++r) part = __fadd_rn(part, __fmul_rn(xv[r], wv[r][p]));
          pbuf[(i * L.tile + c + p) * L.pstride + g] = part;
        }
      }
    }
  }
}

// acc += p[g] for g = 0 .. count - 1, in that order, p 16-byte aligned: the
// partials come four to a load, four loads ahead of the adds, so the chain
// costs about one add per block.
__device__ __forceinline__ float k1_ordered_add(float acc, const float* p, int count) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  int g = 0;
  for (; g + 16 <= count; g += 16) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = p4[g / 4 + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc = __fadd_rn(acc, v[u].x);
      acc = __fadd_rn(acc, v[u].y);
      acc = __fadd_rn(acc, v[u].z);
      acc = __fadd_rn(acc, v[u].w);
    }
  }
  for (; g < count; ++g) acc = __fadd_rn(acc, p[g]);
  return acc;
}

// K1's body: y[b, col] = sum over the table's blocks, in order, of the exact
// block partial. Grid: (D / tile) x (batch slabs of 8). Each CTA scans the
// table once into a flat block list and loads its x rows, then streams
// `blocks`-block stages through a ring of DEPTH + 1 slots: stages t + 1 ..
// t + DEPTH are in flight while stage t is contracted. The first warps form
// a stage's partials at once, into one half of a double buffer; the last
// warps own the outputs: thread (row i, column c) adds the partials into its
// accumulator in ascending block order while the next stage's partials go to
// the other half. That add is the only serial chain left: one add per block.
template <typename T, int DEPTH>
__device__ __forceinline__ void k1_body(unsigned char* smem, const T* __restrict__ w,
                                        const float* __restrict__ x,
                                        const float* __restrict__ xmask,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ sizes,
                                        const float* __restrict__ scales,
                                        float* __restrict__ y, int batch, int n, int d, int k,
                                        int bpc, int tile, int blocks) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int NS = DEPTH + 1;
  const bool masked = xmask != nullptr;
  const K1Layout L(sizeof(T), tile, blocks, min(batch, kBatchSlab), masked, n, NS, k);
  const int col0 = blockIdx.x * tile;
  const int b0 = blockIdx.y * kBatchSlab;
  const int rows = min(kBatchSlab, batch - b0);
  float* pbuf = reinterpret_cast<float*>(smem + L.pbuf_off());
  float* slab = reinterpret_cast<float*>(smem + L.slab_off());
  int* list = reinterpret_cast<int*>(smem + L.list_off(n));
  int* base = reinterpret_cast<int*>(smem + L.base_off(n));
  int* pre = reinterpret_cast<int*>(smem + L.pre_off(n));

  __shared__ uint64_t full[NS];  // stage t has landed (phase parity t / NS)
  __shared__ uint64_t xbar;      // the x slab has landed
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) mbar_init(&full[s], kK1Threads);
    mbar_init(&xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (L.slab) k1_load_slab(slab, &xbar, x, xmask, n, b0, rows);  // lands during the scan
  }
  const int nb = k1_scan_table(starts, sizes, k, n, bpc, base, pre, list, L.window);
  const int n_stages = (nb + blocks - 1) / blocks;
  int list_lo = 0;  // the window of the list in shared memory
  auto issue = [&](int t) {
    if (t < n_stages) {
      const int first = t * blocks;  // windows are whole stages
      if (first >= list_lo + L.window) {
        list_lo = first - first % L.window;
        k1_fill_window(base, pre, k, list_lo, L.window, list);
      }
      k1_issue_stage<T, QUANT>(L, smem + (t % NS) * L.stage_bytes, &full[t % NS],
                               first - list_lo, min(blocks, nb - first), list, w, scales, x,
                               xmask, n, d, col0, b0, rows);
    }
  };
#pragma unroll
  for (int t = 0; t < NS; ++t) issue(t);
  __syncthreads();  // the stages' block offsets are in

  // The last warps own the outputs and only add; the others form partials.
  const int owner_warps = (rows * tile + 31) / 32;
  const int form_warps = kK1Warps - owner_warps;
  const int own = static_cast<int>(threadIdx.x) - form_warps * 32;  // < 0: a forming thread
  const int oi = own / tile;  // an owner's output: slab row oi, column oc
  const int oc = own % tile;
  const bool owner = own >= 0 && oi < rows;
  const size_t half = L.pbuf_half();
  float acc = 0.0f;
  for (int t = 0; t < n_stages; ++t) {
    const int count = min(blocks, nb - t * blocks);
    float* part = pbuf + (t & 1) * half;  // the owners may still read the other half
    if (own < 0) {
      if (t == 0 && L.slab) mbar_wait(&xbar, 0);
      mbar_wait(&full[t % NS], (t / NS) & 1);  // stage t has landed
      k1_form_parts<T, QUANT>(L, smem + (t % NS) * L.stage_bytes, count, rows, masked, slab, n,
                              form_warps, part);
    }
    __syncthreads();  // the partials are in and stage t's slot is free:
    issue(t + NS);    // refill it (stages t + 1 .. t + DEPTH are in flight)
    if (NS == 1) __syncthreads();  // its block offsets are in
    // the owners add stage t while the forming warps go on to stage t + 1
    if (owner) acc = k1_ordered_add(acc, part + (oi * tile + oc) * L.pstride, count);
  }
  if (owner && col0 + oc < d) y[static_cast<size_t>(b0 + oi) * d + col0 + oc] = acc;
  if (L.slab && threadIdx.x == 0) mbar_wait(&xbar, 0);  // an empty table never waited for it
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
__global__ void __launch_bounds__(kK1Threads)
    k1_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const float* __restrict__ xmask, const int* __restrict__ starts,
              const int* __restrict__ sizes, const float* __restrict__ scales,
              float* __restrict__ y, int batch, int n, int d, int k, int bpc, int tile,
              int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  k1_body<T, DEPTH>(smem, w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, tile,
                    blocks);
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
__global__ void __launch_bounds__(kK1Threads)
    k3_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const int* __restrict__ starts, const int* __restrict__ sizes,
              float* __restrict__ y, int batch, int n, int d, int k, int bpc, int tile,
              int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  k1_body<T, 1>(smem, w, x, nullptr, starts, sizes, nullptr, y, batch, n, d, k, bpc, tile,
                blocks);
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

// The K1 body's geometry, chosen by the wrapper (k1_geometry in
// chunk_gather_dma.py): tile columns per CTA, a power of two from one
// 16-byte segment up to 32, and blocks per ring stage.
bool k1_geometry_ok(int elem, int tile, int blocks) {
  return tile * elem >= 16 && tile <= 32 && 32 % tile == 0 && blocks >= 1;
}

size_t k1_smem(int elem, int tile, int blocks, int batch, bool masked, int n, int ns, int k) {
  return K1Layout(elem, tile, blocks, batch < kBatchSlab ? batch : kBatchSlab, masked, n, ns, k)
      .bytes(n);
}

template <typename T, typename Kernel, typename... Args>
int launch_k1_body(Kernel kernel, int ns, bool masked, int batch, int n, int d, int k, int tile,
                   int blocks, cudaStream_t stream, Args... args) {
  if (!k1_geometry_ok(sizeof(T), tile, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + tile - 1) / tile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = k1_smem(sizeof(T), tile, blocks, batch, masked, n, ns, k);
  if (const int rc = reserve_smem(kernel, smem)) return rc;
  kernel<<<grid, kK1Threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DEPTH>
int launch_k1_t(const void* w, const float* x, const float* xmask, const int* starts,
                const int* sizes, const float* scales, float* y, int batch, int n, int d,
                int k, int bpc, int tile, int blocks, cudaStream_t stream) {
  return launch_k1_body<T>(k1_kernel<T, DEPTH>, DEPTH + 1, xmask != nullptr, batch, n, d, k,
                           tile, blocks, stream,
                           static_cast<const T*>(w), x, xmask, starts, sizes, scales, y, batch,
                           n, d, k, bpc, tile, blocks);
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
                    int batch, int n, int d, int k, int bpc, int tile, int blocks,
                    cudaStream_t st) {
  switch (depth) {
    case 0: return launch_k1_t<T, 0>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, tile, blocks, st);
    case 1: return launch_k1_t<T, 1>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, tile, blocks, st);
    case 2: return launch_k1_t<T, 2>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, tile, blocks, st);
    case 3: return launch_k1_t<T, 3>(w, x, xmask, starts, sizes, scales, y, batch, n, d, k, bpc, tile, blocks, st);
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
                int batch, int n, int d, int k, int bpc, int tile, int blocks,
                cudaStream_t stream) {
  return launch_k1_body<T>(k3_kernel<T>, 2, false, batch, n, d, k, tile, blocks, stream,
                           static_cast<const T*>(w), x, starts, sizes, y, batch, n, d, k, bpc,
                           tile, blocks);
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
// tile, blocks: the K1 body's geometry (k1_geometry in chunk_gather_dma.py).
extern "C" int k1_chunk_gather_matmul(const void* w, int wtype, const void* x, const void* xmask,
                                      const void* starts, const void* sizes, const void* scales,
                                      void* y, int batch, int n, int d, int k, int bpc, int depth,
                                      int tile, int blocks, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(xmask);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* sc = static_cast<const float*>(scales);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || d == 0) return 0;
  switch (wtype) {
    case 0: return launch_k1_depth<__nv_bfloat16>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, tile, blocks, s);
    case 1: return launch_k1_depth<float>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, tile, blocks, s);
    case 2: return launch_k1_depth<int8_t>(depth, w, xf, mf, st, sz, sc, yf, batch, n, d, k, bpc, tile, blocks, s);
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
                                      int n, int d, int k, int bpc, int tile, int blocks,
                                      void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || d == 0) return 0;
  switch (wtype) {
    case 0: return launch_k3_t<__nv_bfloat16>(w, xf, st, sz, yf, batch, n, d, k, bpc, tile, blocks, s);
    case 1: return launch_k3_t<float>(w, xf, st, sz, yf, batch, n, d, k, bpc, tile, blocks, s);
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

// Dynamic shared memory of one K1/K3 CTA (wtype as above; depth = the ring's
// prefetch depth, 1 for K3), for the wrapper's check against
// k1_smem_bytes in chunk_gather_dma.py. -1 for a geometry the body refuses.
extern "C" int k1_smem_bytes(int wtype, int tile, int blocks, int batch, int masked, int n,
                             int depth, int k) {
  const int elem = wtype == 0 ? 2 : wtype == 1 ? 4 : wtype == 2 ? 1 : 0;
  if (elem == 0 || !k1_geometry_ok(elem, tile, blocks)) return -1;
  return static_cast<int>(k1_smem(elem, tile, blocks, batch, masked != 0, n, depth + 1, k));
}
