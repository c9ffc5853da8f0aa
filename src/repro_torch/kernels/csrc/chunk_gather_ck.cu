// K1 (chunk_gather_matmul_dma) and K2's phase 1 (chunk_gather_mlp_dma) with
// the checksum lane (the CK flag of chunk_gather.cuh's body): each ring stage
// also fetches one 32-bit word per block and weight stream, waited on with
// the stage and never read, as the reference's kernels carry theirs. Built
// into its own library, beside chunk_gather.cu and in parallel with it.
#include "chunk_gather.cuh"

// Arguments as k1_chunk_gather_matmul's; checksums: the (N / 8,) words.
extern "C" int k1_chunk_gather_matmul_ck(const void* w, int wtype, const void* x,
                                         const void* xmask, const void* starts,
                                         const void* sizes, const void* scales,
                                         const void* checksums, void* y, int batch, int n, int d,
                                         int k, int bpc, int depth, int tile, int blocks,
                                         void* stream) {
  return k1_entry<true>(w, wtype, x, xmask, starts, sizes, scales, checksums, y, batch, n, d, k,
                        bpc, depth, tile, blocks, stream);
}

// Arguments as k2_gate_up's; cg, cu: gate's and up's (N / 8,) words.
extern "C" int k2_gate_up_ck(const void* wg, const void* wu, int wtype, const void* x,
                             const void* starts, const void* sizes, const void* sg,
                             const void* su, const void* cg, const void* cu, void* h, int batch,
                             int n, int f, int k, int bpc, int depth, int tile, int blocks,
                             void* stream) {
  return k2_entry<true>(wg, wu, wtype, x, starts, sizes, sg, su, cg, cu, h, batch, n, f, k, bpc,
                        depth, tile, blocks, stream);
}
