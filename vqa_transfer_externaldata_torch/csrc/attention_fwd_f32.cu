// K2f `attention_fwd_f32`: the gathered-grid attention forward in float32,
// for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_kernel (the
// Pallas body launched by _attention_pallas_fwd) when the model computes
// in float32 (model.dtype float32): the TPU kernel runs in v's dtype (it
// casts W_v and w_s to it), and K2 (attention_fwd.cu) takes only bf16. The
// same function as K2's plain version attention_fwd_reference on a float32
// grid v [B, N, C]:
//
//   r     = 1 / sqrt(sum_c v^2 + 1e-12)      (1 when !normalize)
//   h     = relu((v @ W_v) * r + qh[b])      [N, H] f32
//   alpha = softmax_N(h . w_s)
//   v_att = sum_n (alpha_n r_n) v_n
//
// in FFMA with f32 sums: no TF32 or bf16 pass. It returns r, the per-cell
// norm that K8f (attention_bwd_f32.cu) reuses.
//
// What bounds it on an H100: at B=256, N=196, C=2048, H=512 the score
// product is 2 x 50176 x 2048 x 512 = 105.2 GFLOP of f32 FFMA (1.57 ms at
// 67 TFLOP/s, 0.39 ms at the serving batch 64); the 411 MB of v are read
// in 0.12 ms at 3.35 TB/s: the FP32 pipes.
//
// Design: K4f's three launches (attention_f32.cuh; two without normalize)
// at one glimpse over a dense row source (store_rows_f32.cuh's GridCells:
// cell n of question b read at v[b, n, :] in place, as K2 and K4 share
// score_tile.cuh): the per-cell norm, the score product on fp32_ring.cuh's
// tile loop (v's rows copied by cp.async, 16, 8 or 4 bytes a copy as the
// pitch C * 4 and v's address allow) with the h/score epilogue, the softmax
// with the weighted sum. Any C and H (the tile loop zero-fills what lies
// past them); N * 4 bytes of shared memory hold the softmax. No atomics
// and no split sums: two calls give the same bits.

#include <cuda_runtime.h>

#include "attention_f32.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// v [B, N, C] f32, wv [C, H] f32, qh [B, H] f32, ws [H] f32 -> vatt [B, C]
// f32, alpha [B, N] f32, and rnorm [B, N] f32 (r, written only when
// normalize). Scratch: part [ceil(H/128), B*N] f32. The score launch's
// plan (wa, wb, stages, smem) is ops/kernels.py::f32_ring_plan's. N * 4
// bytes of shared memory (the caller keeps it within 48 KB). Two launches
// (three with normalize) on `stream`, added to *launched.
int attention_fwd_f32(const float* v, const float* wv, const float* qh,
                      const float* ws, float* part, float* rnorm, float* vatt,
                      float* alpha, int B, int N, int C, int H, int normalize,
                      int wa, int wb, int stages, int smem,
                      cudaStream_t stream, int* launched) {
  return attn_f32_fwd(rows_f32::GridCells{v, N, C}, wv, qh, ws, part, rnorm,
                      nullptr, vatt, alpha, B, N, N, C, H, 1, normalize, wa,
                      wb, stages, smem, stream, launched);
}

}  // extern "C"
