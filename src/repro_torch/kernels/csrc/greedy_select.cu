// K5: the utility-ordered greedy walk of batched chunk selection, for sm_90a.
//
// Replaces repro/core/chunking.py::BatchedChunkSelector._greedy_lane (a
// lax.while_loop vmapped over sites — not a Pallas kernel, but the one
// sequential step of a selection refresh).
//
// Bound on the H100: latency. Each candidate's verdict depends on every
// earlier pick, so the walk is a dependent chain; neither bytes nor flops
// bound it. Design: one warp per site lane (no block barriers on the chain),
// the selected rows as a bitmask in shared memory, and candidates taken 32
// at a time: each lane tests its own candidate against the mask in
// parallel, and only the survivors of that test (a few per batch: most
// windows overlap earlier picks) are resolved one by one. The walk stops as
// soon as the remaining budget cannot fit the lane's smallest candidate —
// exactly where the reference's two segments stop, so the selection is
// identical.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned window_bits(int word, int start, int size) {
  const int lo = max(start, word * 32);
  const int hi = min(start + size, word * 32 + 32);
  const int len = hi - lo;
  if (len <= 0) return 0u;
  if (len >= 32) return kFull;
  return ((1u << len) - 1u) << (lo - word * 32);
}

constexpr int kStage = 1024;  // candidates staged in shared memory at a time

__global__ void __launch_bounds__(32)
    k5_kernel(const int* __restrict__ starts_s, const int* __restrict__ sizes_s,
              const int* __restrict__ budgets, const int* __restrict__ min_sizes, int k,
              int n_max, uint8_t* __restrict__ masks, int* __restrict__ selected_out) {
  extern __shared__ unsigned smem[];
  const int n_words = (n_max + 31) / 32;
  unsigned* bits = smem;                                    // n_words + 1
  int* cand_start = reinterpret_cast<int*>(smem + n_words + 1);  // kStage
  int* cand_size = cand_start + kStage;                     // kStage
  const int lane_site = blockIdx.x;
  const int t = threadIdx.x;
  for (int i = t; i <= n_words; i += 32) bits[i] = 0u;

  const int budget = budgets[lane_site];
  const int min_size = min_sizes[lane_site];
  const int* st = starts_s + static_cast<size_t>(lane_site) * k;
  const int* sz = sizes_s + static_cast<size_t>(lane_site) * k;
  int selected = 0;  // uniform across the warp

  // Candidates are staged kStage at a time (32 independent loads per lane
  // in flight), then taken 32 at a time, one per lane. Phase 1 tests each
  // against the state at the batch's start; a rejection there is final,
  // because the mask and `selected` only grow. Phase 2 takes the survivors
  // in candidate order against this batch's own picks, so the selection is
  // exactly the one-by-one walk's.
  bool done = selected + min_size > budget;
  for (int stage = 0; stage < k && !done; stage += kStage) {
    const int count = min(kStage, k - stage);
    __syncwarp();  // the previous stage is consumed
    for (int i = t; i < count; i += 32) {
      cand_start[i] = __ldg(st + stage + i);
      cand_size[i] = __ldg(sz + stage + i);
    }
    __syncwarp();
    for (int base = 0; base < count && !done; base += 32) {
      int my_start = 0, my_size = 0;
      if (base + t < count) {
        my_start = cand_start[base + t];
        my_size = cand_size[base + t];
      }
      bool ok = my_size > 0 && my_size <= budget - selected && my_start >= 0 &&
                my_start + my_size <= n_max;
      if (ok) {
        for (int w = my_start >> 5; w <= (my_start + my_size - 1) >> 5; ++w) {
          if (bits[w] & window_bits(w, my_start, my_size)) {
            ok = false;
            break;
          }
        }
      }
      unsigned live = __ballot_sync(kFull, ok);
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const int start = __shfl_sync(kFull, my_start, j);
        const int size = __shfl_sync(kFull, my_size, j);
        if (size > budget - selected) continue;
        const int w0 = start >> 5;
        const int w1 = (start + size - 1) >> 5;
        bool hit = false;
        for (int w = w0 + t; w <= w1; w += 32) hit |= (bits[w] & window_bits(w, start, size)) != 0u;
        if (__any_sync(kFull, hit)) continue;  // overlaps a pick of this batch
        for (int w = w0 + t; w <= w1; w += 32) bits[w] |= window_bits(w, start, size);
        __syncwarp();
        selected += size;
        if (selected + min_size > budget) {  // nothing can fit any more
          done = true;
          break;
        }
      }
    }
  }
  __syncwarp();

  uint8_t* out = masks + static_cast<size_t>(lane_site) * n_max;
  for (int i = t; i < n_max; i += 32) out[i] = static_cast<uint8_t>((bits[i >> 5] >> (i & 31)) & 1u);
  if (t == 0) selected_out[lane_site] = selected;
}

}  // namespace

// starts_s/sizes_s: (S, K) int32 candidates in descending-utility order
// (size 0 = padding); budgets/min_sizes: (S,) int32; masks: (S, n_max) bytes.
extern "C" int k5_greedy_select(const void* starts_s, const void* sizes_s, const void* budgets,
                                const void* min_sizes, int k, int n_max, void* masks,
                                void* selected, int n_sites, void* stream) {
  if (n_sites == 0) return 0;
  const size_t smem = (static_cast<size_t>((n_max + 31) / 32 + 1) + 2 * kStage) * sizeof(unsigned);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  k5_kernel<<<n_sites, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(starts_s), static_cast<const int*>(sizes_s),
      static_cast<const int*>(budgets), static_cast<const int*>(min_sizes), k, n_max,
      static_cast<uint8_t*>(masks), static_cast<int*>(selected));
  return static_cast<int>(cudaGetLastError());
}
