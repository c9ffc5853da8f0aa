#pragma once

// The shared device code of the chunk-gather kernels, included by
// chunk_gather.cu (K1-K4 without the checksum lane, and the layout query) and
// chunk_gather_ck.cu (K1 and K2's phase 1 with it); each source builds into
// its own library, the two in parallel.
//
// Chunk-gather kernels for sm_90a: K1 (chunk_gather_matmul_dma), K2
// (chunk_gather_mlp_dma: phase 1 gate/up + SwiGLU, phase 2 K1 with an input
// row mask), K3 (chunk_gather_matmul: K1 without a mask) and K4
// (chunk_gather_swiglu: K2's phase 1). All four are shells around one
// device body, k1_body, over one weight stream (K1, K3, K2's phase 2) or
// two streams that share a table (gate and up: K2's phase 1, K4). K3 and K4
// run the ring at depth 1: the BlockSpec pipeline of the Pallas versions
// double-buffers, one block in flight while the last one is contracted.
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
// The body. What bounded the first form of these kernels was a serial chain
// inside each CTA — a table walk, copy issue and an 8-deep partial sum per
// 8-row block, on 4 warps and 4-88 CTAs — not memory. Now: each CTA turns
// the table into a flat block list once (per-entry counts, a block-wide
// scan); the CTAs each take one 32-byte sector of every weight row (16 bf16
// columns; 16 bytes for narrow matrices, for twice the CTAs), so the grid
// covers the SMs and every copy fills a sector; the CTA's x rows are loaded
// once, whole, into shared memory (copying them per block and CTA made
// every CTA hammer the same few L2 lines); each ring stage holds every
// stream's tile of its blocks; of 16 warps, all but the last one or few
// form a stage's partials of every stream at once, two columns a lane,
// while later stages land (cp.async tracked by an mbarrier per ring slot);
// the last warps own the outputs, one thread each with one accumulator per
// stream, and add the partials in table order — the only serial chain
// left, one add per block and stream — while the next stage's partials are
// formed. With two streams the owner writes h = swish(g) * u.
//
// Exact arithmetic (kept bitwise equal to the plain PyTorch versions): per
// 8-row block, part = sum over the rows, in order, of x*w, each product and
// each sum rounded on its own (__fmul_rn/__fadd_rn, built with -fmad=false);
// acc += part in table order. int8 payloads dequantize as q * scale first.
// The SwiGLU is (g * (1 / (1 + expf(-g)))) * u with an IEEE reciprocal.
//
// The checksum lane (template flag CK, as in the reference: one 32-bit word
// per 8-row block, per weight stream): each ring stage also fetches its
// blocks' words with one 4-byte cp.async per block and stream, beside the
// scales, into its own region of the stage, and waits on them with the
// stage's mbarrier. The kernel never reads them: the words are verified at
// the refresh (serving/sparse_exec.py), so the lane changes no output bit.
// Built with CK off, the body is the code without the lane.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockRows = 8;
constexpr int kBatchSlab = 8;                // batch rows per CTA (grid.y)
constexpr int kK1Threads = 512;              // 16 warps
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1WindowBlocks = 1024;        // block-list entries held at once
constexpr int kK1SlabBytes = 80 * 1024;      // x slab (and mask) held whole up to this size

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~static_cast<size_t>(15); }

// k1_body's dynamic shared memory (mirrored by k1_smem_bytes in
// chunk_gather_dma.py), for `nmat` weight streams sharing one table. The
// slab's x rows (and the input mask) are held whole when they fit in
// kK1SlabBytes: loaded once with coalesced copies, they cost the CTA one
// pass over x. Otherwise each block carries an input record of its 8 values
// per row. NS ring stages, each holding `blocks` table blocks: per stream
// their weight tiles (8 rows x `tile` columns, padded by one row so that
// the lane groups reading neighbouring blocks hit other banks), then their
// input records, per stream their scales, their row offsets and, with the
// checksum lane, per stream their checksum words. Then the
// partial buffer (two halves, each nmat x rows x tile outputs x pstride
// blocks f32: each output's partials contiguous, for vector loads in the
// ordered add, and pstride = 4 mod 32 so that the columns a lane group
// writes fall in different banks), the x slab, a window of the flat block
// list, and the table's per-entry first block offset and exclusive prefix.
struct K1Layout {
  int tile, blocks, rows, ns, k, window, xrows, xrec, pstride, nmat;
  bool slab, ck;
  size_t tile_bytes, stage_bytes;

  __host__ __device__ K1Layout(int elem, int tile_, int blocks_, int rows_, bool masked, int n,
                               int ns_, int k_, int nmat_, bool ck_)
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
        nmat(nmat_),
        slab(xrec == 0),
        ck(ck_),
        tile_bytes(static_cast<size_t>(kBlockRows + 1) * tile_ * elem),
        stage_bytes(blocks_ * (nmat_ * tile_bytes + xrec * sizeof(float)) +
                    (nmat_ + 1 + (ck_ ? nmat_ : 0)) * align16(blocks_ * sizeof(int))) {}

  __host__ __device__ size_t tile_off(int m, int g) const {
    return (static_cast<size_t>(m) * blocks + g) * tile_bytes;
  }
  __host__ __device__ size_t xrec_off() const { return static_cast<size_t>(nmat) * blocks * tile_bytes; }
  __host__ __device__ size_t scale_off(int m) const {
    return xrec_off() + blocks * xrec * sizeof(float) + m * align16(blocks * sizeof(int));
  }
  __host__ __device__ size_t offs_off() const { return scale_off(nmat); }
  // stream m's checksum words, after the row offsets (checksum lane only)
  __host__ __device__ size_t ck_off(int m) const { return scale_off(nmat + 1 + m); }
  __host__ __device__ size_t pbuf_off() const { return ns * stage_bytes; }
  // one stream's partials of one stage, in floats
  __host__ __device__ size_t pbuf_mat() const { return static_cast<size_t>(rows) * tile * pstride; }
  __host__ __device__ size_t slab_off() const { return pbuf_off() + 2 * nmat * pbuf_mat() * sizeof(float); }
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
// list entry `first` on: every stream's weight tiles' row segments (16-byte
// cp.async, neighbouring threads on neighbouring segments), the input
// records when x is not held whole (each block's 8 values per slab row and
// of the mask, two copies each), the int8 scales and, with the checksum
// lane, every stream's checksum words (4 bytes a block each) — note the
// blocks' row offsets, and arrive on the stage's mbarrier once the copies
// land.
template <typename T, bool QUANT, bool CK, int NMAT>
__device__ __forceinline__ void k1_issue_stage(const K1Layout& L, unsigned char* stage,
                                               uint64_t* bar, int first, int count,
                                               const int* list, const T* const (&w)[NMAT],
                                               const float* const (&sc)[NMAT],
                                               const uint32_t* const (&ck)[NMAT], const float* x,
                                               const float* xmask, int n, int d, int col0, int b0,
                                               int rows) {
  constexpr int kChunk = 16 / sizeof(T);              // elements per 16-byte copy
  const int seg_shift = __ffs(L.tile / kChunk) - 1;   // log2(copies per tile row)
  const int seg_mask = (1 << seg_shift) - 1;
#pragma unroll
  for (int m = 0; m < NMAT; ++m) {
    for (int c = threadIdx.x; c < (count * kBlockRows) << seg_shift; c += kK1Threads) {
      const int row = c >> seg_shift;  // block row / 8, its row row % 8
      const int cc = (c & seg_mask) * kChunk;
      if (col0 + cc < d) {
        cp_async16(stage + L.tile_off(m, row >> 3) + ((row & 7) * L.tile + cc) * sizeof(T),
                   w[m] + static_cast<size_t>(list[first + (row >> 3)] + (row & 7)) * d + col0 +
                       cc);
      }
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
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      float* scs = reinterpret_cast<float*>(stage + L.scale_off(m));
      for (int g = threadIdx.x; g < count; g += kK1Threads) {
        cp_async4(scs + g, sc[m] + list[first + g] / kBlockRows);
      }
    }
  }
  if (CK) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      uint32_t* cks = reinterpret_cast<uint32_t*>(stage + L.ck_off(m));
      for (int g = threadIdx.x; g < count; g += kK1Threads) {
        cp_async4(cks + g, ck[m] + list[first + g] / kBlockRows);
      }
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
// CTA's lane groups take blocks q, q + step, ... A lane forms its columns
// of every stream, sharing the x loads. A block's inputs are its 8 values
// of each slab row (and of the mask) — at stride n in the x slab, or 8 in
// its input record. For each stream, slab row and column, part = the
// block's 8 products summed in row order, each rounded on its own; rows,
// columns and streams are independent chains.
template <typename T, bool QUANT, int NMAT>
__device__ __forceinline__ void k1_form_parts(const K1Layout& L, const unsigned char* stage,
                                              int count, int rows, bool masked,
                                              const float* slab, int n, int warps,
                                              float* pbuf) {
  constexpr int P = sizeof(T) == 4 ? 1 : 2;
  const int lane = threadIdx.x & 31;
  const int group = L.tile / P;  // lanes per block
  const int nsub = 32 / group;
  const int c = (lane % group) * P;
  const size_t mat = L.pbuf_mat();
  const float* xr = reinterpret_cast<const float*>(stage + L.xrec_off());
  const int* offs = reinterpret_cast<const int*>(stage + L.offs_off());
  const int stride = L.slab ? n : kBlockRows;
  for (int g = (threadIdx.x >> 5) * nsub + lane / group; g < count; g += warps * nsub) {
    float wv[NMAT][kBlockRows][P];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
      const T* tile = reinterpret_cast<const T*>(stage + L.tile_off(m, g)) + c;
      const float scale = QUANT ? reinterpret_cast<const float*>(stage + L.scale_off(m))[g] : 1.0f;
#pragma unroll
      for (int r = 0; r < kBlockRows; ++r) {
        load_cols(tile + r * L.tile, wv[m][r]);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          if (QUANT) wv[m][r][p] = __fmul_rn(wv[m][r][p], scale);
        }
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
        for (int m = 0; m < NMAT; ++m) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            float part = __fmul_rn(xv[0], wv[m][0][p]);
#pragma unroll
            for (int r = 1; r < kBlockRows; ++r) {
              part = __fadd_rn(part, __fmul_rn(xv[r], wv[m][r][p]));
            }
            pbuf[m * mat + (i * L.tile + c + p) * L.pstride + g] = part;
          }
        }
      }
    }
  }
}

// acc[m] += p[m * mat + g] for g = 0 .. count - 1, in that order, for every
// stream m, p 16-byte aligned: the partials come four to a load, four loads
// ahead of the adds, and the streams' chains interleave, so the chain costs
// about one add per block.
template <int NMAT>
__device__ __forceinline__ void k1_ordered_add(float (&acc)[NMAT], const float* p, size_t mat,
                                               int count) {
  int g = 0;
  for (; g + 16 <= count; g += 16) {
    float4 v[NMAT][4];
#pragma unroll
    for (int m = 0; m < NMAT; ++m) {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[m][u] = reinterpret_cast<const float4*>(p + m * mat)[g / 4 + u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
        acc[m] = __fadd_rn(acc[m], v[m][u].x);
        acc[m] = __fadd_rn(acc[m], v[m][u].y);
        acc[m] = __fadd_rn(acc[m], v[m][u].z);
        acc[m] = __fadd_rn(acc[m], v[m][u].w);
      }
    }
  }
  for (; g < count; ++g) {
#pragma unroll
    for (int m = 0; m < NMAT; ++m) acc[m] = __fadd_rn(acc[m], p[m * mat + g]);
  }
}

// The body: per stream m, acc_m[b, col] = sum over the table's blocks, in
// order, of the exact block partial; one stream writes y = acc_0, two write
// h = (g * (1 / (1 + exp(-g)))) * u with g = acc_0, u = acc_1. Grid:
// (D / tile) x (batch slabs of 8). Each CTA scans the table once into a
// flat block list and loads its x rows, then streams `blocks`-block stages
// through a ring of DEPTH + 1 slots: stages t + 1 .. t + DEPTH are in flight
// while stage t is contracted. The first warps form a stage's partials at
// once, into one half of a double buffer; the last warps own the outputs:
// thread (row i, column c) adds the partials into its accumulators in
// ascending block order while the next stage's partials go to the other
// half. That add is the only serial chain left: one add per block. CK: the
// stages also carry every stream's checksum words (`cks`), unread.
template <typename T, int DEPTH, int NMAT, bool CK>
__device__ __forceinline__ void k1_body(unsigned char* smem, const T* const (&w)[NMAT],
                                        const float* __restrict__ x,
                                        const float* __restrict__ xmask,
                                        const int* __restrict__ starts,
                                        const int* __restrict__ sizes,
                                        const float* const (&scales)[NMAT],
                                        const uint32_t* const (&cks)[NMAT],
                                        float* __restrict__ y, int batch, int n, int d, int k,
                                        int bpc, int tile, int blocks) {
  constexpr bool QUANT = std::is_same<T, int8_t>::value;
  constexpr int NS = DEPTH + 1;
  const bool masked = xmask != nullptr;
  const K1Layout L(sizeof(T), tile, blocks, min(batch, kBatchSlab), masked, n, NS, k, NMAT, CK);
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
      k1_issue_stage<T, QUANT, CK, NMAT>(L, smem + (t % NS) * L.stage_bytes, &full[t % NS],
                                         first - list_lo, min(blocks, nb - first), list, w, scales,
                                         cks, x, xmask, n, d, col0, b0, rows);
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
  const size_t mat = L.pbuf_mat();
  float acc[NMAT];
#pragma unroll
  for (int m = 0; m < NMAT; ++m) acc[m] = 0.0f;
  for (int t = 0; t < n_stages; ++t) {
    const int count = min(blocks, nb - t * blocks);
    float* part = pbuf + (t & 1) * NMAT * mat;  // the owners may still read the other half
    if (own < 0) {
      if (t == 0 && L.slab) mbar_wait(&xbar, 0);
      mbar_wait(&full[t % NS], (t / NS) & 1);  // stage t has landed
      k1_form_parts<T, QUANT, NMAT>(L, smem + (t % NS) * L.stage_bytes, count, rows, masked, slab,
                                    n, form_warps, part);
    }
    __syncthreads();  // the partials are in and stage t's slot is free:
    issue(t + NS);    // refill it (stages t + 1 .. t + DEPTH are in flight)
    if (NS == 1) __syncthreads();  // its block offsets are in
    // the owners add stage t while the forming warps go on to stage t + 1
    if (owner) k1_ordered_add<NMAT>(acc, part + (oi * tile + oc) * L.pstride, mat, count);
  }
  if (owner && col0 + oc < d) {
    float out = acc[0];
    if (NMAT == 2) {
      const float g = acc[0];
      const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-g)));
      out = __fmul_rn(__fmul_rn(g, sig), acc[NMAT - 1]);
    }
    y[static_cast<size_t>(b0 + oi) * d + col0 + oc] = out;
  }
  if (L.slab && threadIdx.x == 0) mbar_wait(&xbar, 0);  // an empty table never waited for it
}

// The kernels: shells around the body, one entry function each, so ptxas
// and the profiler name them apart.
template <typename T, int DEPTH, bool CK>
__global__ void __launch_bounds__(kK1Threads)
    k1_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const float* __restrict__ xmask, const int* __restrict__ starts,
              const int* __restrict__ sizes, const float* __restrict__ scales,
              const uint32_t* __restrict__ ck, float* __restrict__ y, int batch, int n, int d,
              int k, int bpc, int tile, int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* const ws[1] = {w};
  const float* const scs[1] = {scales};
  const uint32_t* const cks[1] = {ck};
  k1_body<T, DEPTH, 1, CK>(smem, ws, x, xmask, starts, sizes, scs, cks, y, batch, n, d, k, bpc,
                           tile, blocks);
}

// K2's phase 1: gate and up off the hidden lane's table, h = swish(g) * u.
template <typename T, int DEPTH, bool CK>
__global__ void __launch_bounds__(kK1Threads)
    k2_gate_up_kernel(const T* __restrict__ wg, const T* __restrict__ wu,
                      const float* __restrict__ x, const int* __restrict__ starts,
                      const int* __restrict__ sizes, const float* __restrict__ sg,
                      const float* __restrict__ su, const uint32_t* __restrict__ cg,
                      const uint32_t* __restrict__ cu, float* __restrict__ h, int batch, int n,
                      int f, int k, int bpc, int tile, int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* const ws[2] = {wg, wu};
  const float* const scs[2] = {sg, su};
  const uint32_t* const cks[2] = {cg, cu};
  k1_body<T, DEPTH, 2, CK>(smem, ws, x, nullptr, starts, sizes, scs, cks, h, batch, n, f, k, bpc,
                           tile, blocks);
}

// K3: K1 at depth 1 with no input mask (floating-point weights only).
template <typename T>
__global__ void __launch_bounds__(kK1Threads)
    k3_kernel(const T* __restrict__ w, const float* __restrict__ x,
              const int* __restrict__ starts, const int* __restrict__ sizes,
              float* __restrict__ y, int batch, int n, int d, int k, int bpc, int tile,
              int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* const ws[1] = {w};
  const float* const scs[1] = {nullptr};
  const uint32_t* const cks[1] = {nullptr};
  k1_body<T, 1, 1, false>(smem, ws, x, nullptr, starts, sizes, scs, cks, y, batch, n, d, k, bpc,
                          tile, blocks);
}

// K4: K2's phase 1 at depth 1 (floating-point weights only).
template <typename T>
__global__ void __launch_bounds__(kK1Threads)
    k4_kernel(const T* __restrict__ wg, const T* __restrict__ wu, const float* __restrict__ x,
              const int* __restrict__ starts, const int* __restrict__ sizes,
              float* __restrict__ h, int batch, int n, int f, int k, int bpc, int tile,
              int blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* const ws[2] = {wg, wu};
  const float* const scs[2] = {nullptr, nullptr};
  const uint32_t* const cks[2] = {nullptr, nullptr};
  k1_body<T, 1, 2, false>(smem, ws, x, nullptr, starts, sizes, scs, cks, h, batch, n, f, k, bpc,
                          tile, blocks);
}

// Shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes)));
}

// The body's geometry, chosen by the wrapper (k1_geometry in
// chunk_gather_dma.py): tile columns per CTA, a power of two from one
// 16-byte segment up to 32, and blocks per ring stage.
bool k1_geometry_ok(int elem, int tile, int blocks) {
  return tile * elem >= 16 && tile <= 32 && 32 % tile == 0 && blocks >= 1;
}

size_t k1_smem(int elem, int tile, int blocks, int batch, bool masked, int n, int ns, int k,
               int nmat, bool ck) {
  return K1Layout(elem, tile, blocks, batch < kBatchSlab ? batch : kBatchSlab, masked, n, ns, k,
                  nmat, ck)
      .bytes(n);
}

template <typename T, typename Kernel, typename... Args>
int launch_k1_body(Kernel kernel, int ns, bool masked, int nmat, bool ck, int batch, int n, int d,
                   int k, int tile, int blocks, cudaStream_t stream, Args... args) {
  if (!k1_geometry_ok(sizeof(T), tile, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + tile - 1) / tile, (batch + kBatchSlab - 1) / kBatchSlab);
  const size_t smem = k1_smem(sizeof(T), tile, blocks, batch, masked, n, ns, k, nmat, ck);
  if (const int rc = reserve_smem(kernel, smem)) return rc;
  kernel<<<grid, kK1Threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// K1 and K2's phase 1, built with (CK) or without the checksum lane: the
// lane's kernels are instantiated only in chunk_gather_ck.cu, the others only
// in chunk_gather.cu, so the two libraries build in parallel.
template <typename T, int DEPTH, bool CK>
int launch_k1_t(const void* w, const float* x, const float* xmask, const int* starts,
                const int* sizes, const float* scales, const uint32_t* ck, float* y, int batch,
                int n, int d, int k, int bpc, int tile, int blocks, cudaStream_t stream) {
  return launch_k1_body<T>(k1_kernel<T, DEPTH, CK>, DEPTH + 1, xmask != nullptr, 1, CK, batch, n,
                           d, k, tile, blocks, stream, static_cast<const T*>(w), x, xmask, starts,
                           sizes, scales, ck, y, batch, n, d, k, bpc, tile, blocks);
}

template <typename T, int DEPTH, bool CK>
int launch_k2_t(const void* wg, const void* wu, const float* x, const int* starts,
                const int* sizes, const float* sg, const float* su, const uint32_t* cg,
                const uint32_t* cu, float* h, int batch, int n, int f, int k, int bpc, int tile,
                int blocks, cudaStream_t stream) {
  return launch_k1_body<T>(k2_gate_up_kernel<T, DEPTH, CK>, DEPTH + 1, false, 2, CK, batch, n, f,
                           k, tile, blocks, stream, static_cast<const T*>(wg),
                           static_cast<const T*>(wu), x, starts, sizes, sg, su, cg, cu, h, batch,
                           n, f, k, bpc, tile, blocks);
}

template <typename T, bool CK>
int launch_k1_depth(int depth, const void* w, const float* x, const float* xmask,
                    const int* starts, const int* sizes, const float* scales, const uint32_t* ck,
                    float* y, int batch, int n, int d, int k, int bpc, int tile, int blocks,
                    cudaStream_t st) {
  switch (depth) {
    case 0: return launch_k1_t<T, 0, CK>(w, x, xmask, starts, sizes, scales, ck, y, batch, n, d, k, bpc, tile, blocks, st);
    case 1: return launch_k1_t<T, 1, CK>(w, x, xmask, starts, sizes, scales, ck, y, batch, n, d, k, bpc, tile, blocks, st);
    case 2: return launch_k1_t<T, 2, CK>(w, x, xmask, starts, sizes, scales, ck, y, batch, n, d, k, bpc, tile, blocks, st);
    case 3: return launch_k1_t<T, 3, CK>(w, x, xmask, starts, sizes, scales, ck, y, batch, n, d, k, bpc, tile, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, bool CK>
int launch_k2_depth(int depth, const void* wg, const void* wu, const float* x,
                    const int* starts, const int* sizes, const float* sg, const float* su,
                    const uint32_t* cg, const uint32_t* cu, float* h, int batch, int n, int f,
                    int k, int bpc, int tile, int blocks, cudaStream_t st) {
  switch (depth) {
    case 0: return launch_k2_t<T, 0, CK>(wg, wu, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc, tile, blocks, st);
    case 1: return launch_k2_t<T, 1, CK>(wg, wu, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc, tile, blocks, st);
    case 2: return launch_k2_t<T, 2, CK>(wg, wu, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc, tile, blocks, st);
    case 3: return launch_k2_t<T, 3, CK>(wg, wu, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc, tile, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The C entry points' body: wtype 0 = bf16, 1 = f32, 2 = int8 (then the
// scales are the per-block lane); a checksum lane present iff CK.
template <bool CK>
int k1_entry(const void* w, int wtype, const void* x, const void* xmask, const void* starts,
             const void* sizes, const void* scales, const void* checksums, void* y, int batch,
             int n, int d, int k, int bpc, int depth, int tile, int blocks, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(xmask);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* sc = static_cast<const float*>(scales);
  const auto* ck = static_cast<const uint32_t*>(checksums);
  auto* yf = static_cast<float*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if ((ck != nullptr) != CK) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || d == 0) return 0;
  switch (wtype) {
    case 0: return launch_k1_depth<__nv_bfloat16, CK>(depth, w, xf, mf, st, sz, sc, ck, yf, batch, n, d, k, bpc, tile, blocks, s);
    case 1: return launch_k1_depth<float, CK>(depth, w, xf, mf, st, sz, sc, ck, yf, batch, n, d, k, bpc, tile, blocks, s);
    case 2: return launch_k1_depth<int8_t, CK>(depth, w, xf, mf, st, sz, sc, ck, yf, batch, n, d, k, bpc, tile, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cg, cu: gate's and up's checksum lanes, both present iff CK.
template <bool CK>
int k2_entry(const void* wg, const void* wu, int wtype, const void* x, const void* starts,
             const void* sizes, const void* sg, const void* su, const void* cg, const void* cu,
             void* h, int batch, int n, int f, int k, int bpc, int depth, int tile, int blocks,
             void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  const auto* g = static_cast<const float*>(sg);
  const auto* u = static_cast<const float*>(su);
  const auto* ckg = static_cast<const uint32_t*>(cg);
  const auto* cku = static_cast<const uint32_t*>(cu);
  auto* hf = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if ((ckg != nullptr) != CK || (cku != nullptr) != CK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || f == 0) return 0;
  switch (wtype) {
    case 0: return launch_k2_depth<__nv_bfloat16, CK>(depth, wg, wu, xf, st, sz, g, u, ckg, cku, hf, batch, n, f, k, bpc, tile, blocks, s);
    case 1: return launch_k2_depth<float, CK>(depth, wg, wu, xf, st, sz, g, u, ckg, cku, hf, batch, n, f, k, bpc, tile, blocks, s);
    case 2: return launch_k2_depth<int8_t, CK>(depth, wg, wu, xf, st, sz, g, u, ckg, cku, hf, batch, n, f, k, bpc, tile, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_k3_t(const void* w, const float* x, const int* starts, const int* sizes, float* y,
                int batch, int n, int d, int k, int bpc, int tile, int blocks,
                cudaStream_t stream) {
  return launch_k1_body<T>(k3_kernel<T>, 2, false, 1, false, batch, n, d, k, tile, blocks, stream,
                           static_cast<const T*>(w), x, starts, sizes, y, batch, n, d, k, bpc,
                           tile, blocks);
}

template <typename T>
int launch_k4_t(const void* wg, const void* wu, const float* x, const int* starts,
                const int* sizes, float* h, int batch, int n, int f, int k, int bpc, int tile,
                int blocks, cudaStream_t stream) {
  return launch_k1_body<T>(k4_kernel<T>, 2, false, 2, false, batch, n, f, k, tile, blocks, stream,
                           static_cast<const T*>(wg), static_cast<const T*>(wu), x, starts,
                           sizes, h, batch, n, f, k, bpc, tile, blocks);
}

}  // namespace

