// flash_attention_fwd: softmax attention over (B, H, N, D) bf16 q, k, v,
// keys at or past n_valid masked, bf16 output and optionally the fp32 LSE
// (B, H, N) that a blocked backward reads.
//
// Replaces both TPU flash forwards of myrtle_vision_tpu/ops/flash_attention.py:
// the unblocked `_fwd_kernel` (K5, n_pad <= 1536: scores of the whole
// sequence in VMEM, p = e / rowsum rounded to bf16 before P V) and the
// blocked `_blk_fwd_kernel` (K6: online softmax over KV tiles, bf16(e) V
// accumulated in fp32, / l at the end, the LSE emitted).  Both compute the
// same function, so one kernel serves both (flash_tiles.cuh, flash mode):
// it rounds as K6 does; against K5 it rounds e where K5 rounds p, which
// moves an output by about 2^-9 of itself.
//
// What bounds it on the H100: at the detection eval's (8, 6, 2601, 64) the
// two products are 4 N^2 D B H = 83 GFLOP against 64 MB of q, k, v and o,
// so the tensor cores (0.084 ms at 989 TFLOP/s) and not the memory
// (0.019 ms at 3.35 TB/s).  This first design keeps the scores, softmax
// state and output accumulator in registers and overlaps each KV tile's
// copy with the previous tile's products (cp.async, two stages); it issues
// mma.sync, not wgmma, and has no warp specialisation, so it runs well
// below the tensor-core peak.
#include "flash_tiles.cuh"

MVT_EXPORT int mvt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long in_image, int in_head, int in_row, long long out_image,
    int out_head, int out_row, int B, int H, int N, int D, int n_valid,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || n_valid <= 0 || n_valid > N ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  mvt::flash::Params p;
  p.q = static_cast<const mvt::bf16*>(q);
  p.k = static_cast<const mvt::bf16*>(k);
  p.v = static_cast<const mvt::bf16*>(v);
  p.o = static_cast<mvt::bf16*>(o);
  p.stat0 = static_cast<float*>(lse);
  p.stat1 = nullptr;
  p.in_image = in_image;
  p.in_head = in_head;
  p.in_row = in_row;
  p.out_image = out_image;
  p.out_head = out_head;
  p.out_row = out_row;
  p.heads = H;
  p.n = N;
  p.n_valid = n_valid;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return mvt::flash::launch<64, false>(p, B, s);
  if (D == 32) return mvt::flash::launch<32, false>(p, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
