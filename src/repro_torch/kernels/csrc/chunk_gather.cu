// K1 (chunk_gather_matmul_dma), K2's phase 1 (chunk_gather_mlp_dma), K3
// (chunk_gather_matmul) and K4 (chunk_gather_swiglu) without the checksum
// lane, on the shared body of chunk_gather.cuh (its header says what each
// replaces, what bounds it and how it is built); the lane-carrying K1 and
// K2 phase 1 are in chunk_gather_ck.cu.
#include "chunk_gather.cuh"

// K1 and K2's phase 1 without the checksum lane (its pointers must be
// null; the lane's entry points are in chunk_gather_ck.cu). tile, blocks: the
// body's geometry (k1_geometry in chunk_gather_dma.py).
extern "C" int k1_chunk_gather_matmul(const void* w, int wtype, const void* x, const void* xmask,
                                      const void* starts, const void* sizes, const void* scales,
                                      const void* checksums, void* y, int batch, int n, int d,
                                      int k, int bpc, int depth, int tile, int blocks,
                                      void* stream) {
  return k1_entry<false>(w, wtype, x, xmask, starts, sizes, scales, checksums, y, batch, n, d, k,
                         bpc, depth, tile, blocks, stream);
}

extern "C" int k2_gate_up(const void* wg, const void* wu, int wtype, const void* x,
                          const void* starts, const void* sizes, const void* sg, const void* su,
                          const void* cg, const void* cu, void* h, int batch, int n, int f, int k,
                          int bpc, int depth, int tile, int blocks, void* stream) {
  return k2_entry<false>(wg, wu, wtype, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc,
                         depth, tile, blocks, stream);
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
                                      int n, int f, int k, int bpc, int tile, int blocks,
                                      void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* st = static_cast<const int*>(starts);
  const auto* sz = static_cast<const int*>(sizes);
  auto* hf = static_cast<float*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  if (batch == 0 || f == 0) return 0;
  switch (wtype) {
    case 0: return launch_k4_t<__nv_bfloat16>(wg, wu, xf, st, sz, hf, batch, n, f, k, bpc, tile, blocks, s);
    case 1: return launch_k4_t<float>(wg, wu, xf, st, sz, hf, batch, n, f, k, bpc, tile, blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of one CTA of the body (wtype as above; depth = the
// ring's prefetch depth, 1 for K3/K4; nmat = 1 for K1/K3, 2 for K2's phase
// 1 and K4; ck = 1 with the checksum lane), for the wrapper's check against
// k1_smem_bytes in chunk_gather_dma.py. -1 for a geometry the body refuses.
extern "C" int k1_smem_bytes(int wtype, int tile, int blocks, int batch, int masked, int n,
                             int depth, int k, int nmat, int ck) {
  const int elem = wtype == 0 ? 2 : wtype == 1 ? 4 : wtype == 2 ? 1 : 0;
  if (elem == 0 || (nmat != 1 && nmat != 2) || !k1_geometry_ok(elem, tile, blocks)) return -1;
  return static_cast<int>(
      k1_smem(elem, tile, blocks, batch, masked != 0, n, depth + 1, k, nmat, ck != 0));
}
