// K5: the utility-ordered greedy walk of batched chunk selection, for sm_90a.
//
// Replaces repro/core/chunking.py::BatchedChunkSelector._greedy_lane (a
// lax.while_loop vmapped over sites — not a Pallas kernel, but the one
// sequential step of a selection refresh). One launch walks every lane of
// a refresh step: the sites of every layer (L x S lanes, 88 for
// TinyLlama-1.1B), one CTA of one warp each, so the lanes run side by side
// on the SMs and the launch takes as long as its longest walk.
//
// Bound on the H100: a dependent chain, not bytes. Each candidate's verdict
// depends on every earlier pick, and a lane reads only ~8 bytes per
// candidate it walks. One warp alone on its SM hides no latency and issues
// one instruction a cycle at best, so what a lane costs is the work per
// candidate it walks: on TinyLlama a lane walks ~1000 batches of 32
// candidates (the ffn lanes up to ~2300) and only ~0.13 survivors per batch
// reach resolution, so the batch test was the cost — with the selected rows
// as a bitmask, ~300 of ~550-700 cycles a batch went to building and
// testing the window's word masks (clock64 stamps, PERF.md), and testing
// several batches at once did not help, since the instructions, not their
// latency, were the limit.
// Design: the selection as nxt[i] = the first selected row at or after row
// i (n_max if none), in shared memory, so the test of a window [s, e) is one
// load and one compare: it is free iff nxt[s] >= e. A pick of [s, e) sets
// nxt[i] = i on the window and nxt[i] = s on the free rows before it, found
// by a warp-wide backward scan (they all hold the old nxt[s]), 128 rows a
// round; picks are rare, and the scans add up to a few rows per row of the
// matrix.
// Candidates are staged 1024 at a time by cp.async, the next three stages
// in flight while the current one is walked, and kU batches of 32 are tested
// at once, each lane testing its own kU candidates against the selection as
// it stood (a rejection there is final: the selection and `selected` only
// grow). Then the batches in order: a batch after a pick tests its
// survivors again, and a batch's survivors are resolved one by one, as the
// one-by-one walk does (they are rare, so this is not where the time goes).
// The walk stops as soon as the remaining budget cannot fit the lane's
// smallest candidate — exactly where the reference's two segments stop, so
// the selection is identical.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 1024;  // candidates staged in shared memory at a time
constexpr int kRing = 4;      // stages held: kRing - 1 in flight while one is walked
constexpr int kU = 4;         // batches of 32 candidates tested at once
static_assert(kStage % (32 * kU) == 0, "a stage holds whole rounds of kU batches");

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// Stage the lane's candidates [first, first + kStage) ∩ [0, k) into ring
// slot `slot` (starts, then sizes) as one cp.async group — an empty group
// past the end, so that every stage commits exactly one. `vec`: the rows
// are 16-byte aligned and k is a multiple of 4, so four candidates a copy.
__device__ __forceinline__ void stage_candidates(int* cand, int slot, const int* st,
                                                 const int* sz, int first, int k, bool vec) {
  int* cs = cand + slot * 2 * kStage;
  const int end = min(first + kStage, k);
  if (vec) {
    for (int i = first + 4 * static_cast<int>(threadIdx.x); i < end; i += 128) {
      cp_async16(cs + (i - first), st + i);
      cp_async16(cs + kStage + (i - first), sz + i);
    }
  } else {
    for (int i = first + threadIdx.x; i < end; i += 32) {
      cp_async4(cs + (i - first), st + i);
      cp_async4(cs + kStage + (i - first), sz + i);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The batch test of one candidate: a real window that fits the rows left
// in the budget and meets no selected row. Straight-line code.
__device__ __forceinline__ bool batch_test(const int* nxt, int start, int size, int room,
                                           int n_max) {
  const bool valid = (size > 0) & (size <= room) & (start >= 0) & (start + size <= n_max);
  return valid & (nxt[valid ? start : 0] >= start + size);
}

// Select the free window [s, e), by the whole warp: nxt[i] = i on it, and
// nxt[i] = s on the free rows before it back to the previous selected row
// (they, like row s, hold q = the first selected row after the window),
// found 128 rows per round: four 32-row chunks read at once.
__device__ __forceinline__ void pick(int* nxt, int s, int e) {
  const int t = threadIdx.x;
  const unsigned below = (1u << t) - 1u;  // the lanes that look at higher rows
  const int q = nxt[s];
  __syncwarp();
  for (int i = s + t; i < e; i += 32) nxt[i] = i;
  for (int top = s - 1; top >= 0; top -= 128) {
    bool free_row[4];
    unsigned stop[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = top - 32 * c - t;
      free_row[c] = i >= 0 && nxt[i] == q;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) stop[c] = __ballot_sync(kFull, !free_row[c]);
    bool blocked = false;  // the previous selected row (or row -1) is reached
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!blocked && free_row[c] && (stop[c] & below) == 0u) nxt[top - 32 * c - t] = s;
      blocked |= stop[c] != 0u;
    }
    if (blocked) break;
  }
  __syncwarp();
}

// One batch's survivors `live` (this lane's window [my_start, my_start +
// my_size) if its bit is set), one by one in candidate order, against the
// batch's own picks: updates nxt, `selected` and `done` exactly as the
// one-by-one walk would. Returns whether anything was picked.
__device__ __forceinline__ bool resolve(int* nxt, unsigned live, int my_start, int my_size,
                                        int budget, int min_size, int& selected, bool& done) {
  const int before = selected;
  for (unsigned l = live; l; l &= l - 1) {
    const int j = __ffs(l) - 1;
    const int start = __shfl_sync(kFull, my_start, j);
    const int size = __shfl_sync(kFull, my_size, j);
    if (size > budget - selected || nxt[start] < start + size) continue;
    pick(nxt, start, start + size);
    selected += size;
    if (selected + min_size > budget) {  // nothing can fit any more
      done = true;
      break;
    }
  }
  return selected != before;
}

__global__ void __launch_bounds__(32)
    k5_kernel(const int* __restrict__ starts_s, const int* __restrict__ sizes_s,
              const int* __restrict__ budgets, const int* __restrict__ min_sizes, int k,
              int n_max, uint8_t* __restrict__ masks, int* __restrict__ selected_out) {
  extern __shared__ int smem[];
  int* nxt = smem;                   // n_max + 1 (nxt[n_max] = n_max)
  int* cand = smem + (n_max + 4) / 4 * 4;  // kRing x (starts, sizes), 16-byte aligned
  const int lane_site = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i <= n_max; i += 32) nxt[i] = n_max;

  const int budget = budgets[lane_site];
  const int min_size = min_sizes[lane_site];
  const int* st = starts_s + static_cast<size_t>(lane_site) * k;
  const int* sz = sizes_s + static_cast<size_t>(lane_site) * k;
  int selected = 0;  // uniform across the warp

  bool done = selected + min_size > budget;
  const bool vec = (k & 3) == 0 && ((reinterpret_cast<uintptr_t>(st) |
                                     reinterpret_cast<uintptr_t>(sz)) & 15) == 0;
  if (!done) {
#pragma unroll
    for (int r = 0; r < kRing - 1; ++r) stage_candidates(cand, r, st, sz, r * kStage, k, vec);
  }
  for (int stage = 0; stage * kStage < k && !done; ++stage) {
    const int count = min(kStage, k - stage * kStage);
    const int* cs = cand + (stage % kRing) * 2 * kStage;
    const int* cz = cs + kStage;
    // this stage has landed (the kRing - 2 after it may not have), and the
    // slot of the one before it is consumed: refill it kRing - 1 ahead
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncwarp();
    stage_candidates(cand, (stage + kRing - 1) % kRing, st, sz, (stage + kRing - 1) * kStage, k,
                     vec);
    for (int base = 0; base < count && !done; base += 32 * kU) {
      // kU batches tested at once against the selection as it stands; a
      // rejection is final, because the selection and `selected` only grow
      int my_start[kU], my_size[kU];
      unsigned live[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int i = base + u * 32 + t;  // < kStage: base is a multiple of 32 * kU
        my_start[u] = cs[i];
        my_size[u] = i < count ? cz[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        live[u] = __ballot_sync(
            kFull, batch_test(nxt, my_start[u], my_size[u], budget - selected, n_max));
      }
      // then the batches in order: a batch after a pick tests its survivors
      // again against the picks of the batches before it
      bool picked = false;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (done || live[u] == 0u) continue;
        unsigned l = live[u];
        if (picked) {
          l &= __ballot_sync(
              kFull, batch_test(nxt, my_start[u], my_size[u], budget - selected, n_max));
          if (l == 0u) continue;
        }
        picked |= resolve(nxt, l, my_start[u], my_size[u], budget, min_size, selected, done);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // no copy outlives the CTA
  __syncwarp();

  uint8_t* out = masks + static_cast<size_t>(lane_site) * n_max;
  for (int i = t; i < n_max; i += 32) out[i] = static_cast<uint8_t>(nxt[i] == i);
  if (t == 0) selected_out[lane_site] = selected;
}

}  // namespace

// starts_s/sizes_s: (S, K) int32 candidates in descending-utility order
// (size 0 = padding), S lanes (every site of every layer of a refresh
// step); budgets/min_sizes: (S,) int32; masks: (S, n_max) bytes.
extern "C" int k5_greedy_select(const void* starts_s, const void* sizes_s, const void* budgets,
                                const void* min_sizes, int k, int n_max, void* masks,
                                void* selected, int n_sites, void* stream) {
  if (n_sites == 0) return 0;
  const size_t smem =
      (static_cast<size_t>((n_max + 4) / 4 * 4) + 2 * kRing * kStage) * sizeof(int);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {  // shared memory above 48 KB needs an opt-in
    const cudaError_t rc = cudaFuncSetAttribute(
        k5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  k5_kernel<<<n_sites, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts_s), static_cast<const int*>(sizes_s),
      static_cast<const int*>(budgets), static_cast<const int*>(min_sizes), k, n_max,
      static_cast<uint8_t*>(masks), static_cast<int*>(selected));
  return static_cast<int>(cudaGetLastError());
}
