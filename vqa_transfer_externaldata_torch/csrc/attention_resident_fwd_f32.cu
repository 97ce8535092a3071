// K4f `attention_resident_fwd_f32`: the gather-free attention forward with
// G glimpses (1 <= G <= 8) in float32, over a feature store resident in
// device memory, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_fwd_kernel_multi (the Pallas body launched by _resident_fwd_multi)
// when the store computes in float32: the TPU kernel runs in the store's
// dtype (float32 in model.dtype float32 and in model.fidelity_mode, where
// the model's other ops run plain), and K4 (attention_resident_fwd.cu)
// takes only bf16 rows. The same function as K4's plain version
// attention_resident_fwd_reference in float32:
//
//   v       = store[rows[b]]                      [Np, C], widened to f32
//   r       = 1 / sqrt(sum_c v^2 + 1e-12)         (1 when !normalize)
//   h       = relu((v @ W_v) * r + qh[b])         [Np, H] f32; saved on ask
//   s_g     = h . ws_g, -1e30 at cells >= n_valid (each glimpse)
//   alpha_g = softmax_Np(s_g)
//   v_att_g = sum_n (alpha_gn r_n) v_n            (concatenated in g order)
//
// on rows of f32, f16 or int8 codes (widened exactly as they load,
// store_rows_f32.cuh), in FFMA with f32 sums: no TF32 or bf16 pass, as the
// path exists to meet a float64 oracle at 1e-4.
//
// What bounds it on an H100: at B=256, n_valid=196 (Np=200), C=2048, H=512
// the score product over the valid cells is 2 x 50176 x 2048 x 512 = 105.2
// GFLOP of f32 FFMA (1.6 ms at 67 TFLOP/s; this kernel also runs it over
// the 4 padded cells of each row, 107.4 GFLOP in all); its reads (420 MB
// of f32 rows, 210 MB of f16) and the 105 MB of saved h take 0.16 ms at
// 3.35 TB/s: the FP32 pipes.
//
// Design: attention_f32.cuh's three launches (two without normalize) over
// the store's rows (store_rows_f32.cuh's CellRows, in place of the TPU's
// scalar prefetch): the per-cell norm, the score product on fp32_ring.cuh's
// tile loop (each of a tile's 128 cells' store row found once, the rows
// copied by cp.async in their stored type, 16, 8 or 4 bytes a copy as
// their pitch allows, widened in shared memory) with the h/score epilogue,
// the softmaxes with the weighted sums. K2f (attention_fwd_f32.cu) runs
// the same launches over a dense grid. No atomics and no split sums: two
// calls give the same bits.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_f32.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] of f32 (row_type 0), f16 (1) or int8 codes (2; then
// normalize must be 0), rows [B] i32 (< M, checked by the caller), wv
// [C, H] f32, qh [B, H] f32, ws [G, H] f32 (1 <= G <= 8) -> vatt [B, G, C]
// f32, alpha [B, Np, G] f32 (0 at cells >= n_valid), and h [B, Np, H] f32
// when hsave is not null. Scratch: part [ceil(H/128), G, B*Np] f32, rnorm
// [B*Np] f32. The score launch's plan: copy widths wa (the rows) and wb
// (W_v) in bytes, stages and shared bytes, ops/kernels.py::f32_ring_plan's
// (refused where the rows' alignment does not allow it). Np * G * 4 bytes
// of shared memory for the softmaxes (the caller keeps it within a
// block's). Two launches (three with normalize) on `stream`, added to
// *launched.
int attention_resident_fwd_f32(const void* store, const int* rows,
                               const float* wv, const float* qh,
                               const float* ws, float* part, float* rnorm,
                               float* hsave, float* vatt, float* alpha, int B,
                               int Np, int n_valid, int C, int H, int G,
                               int normalize, int row_type, int wa, int wb,
                               int stages, int smem, cudaStream_t stream,
                               int* launched) {
  switch (row_type) {
    case 0:
      return attn_f32_fwd(
          rows_f32::CellRows<float>{static_cast<const float*>(store), rows,
                                    Np, C},
          wv, qh, ws, part, rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H,
          G, normalize, wa, wb, stages, smem, stream, launched);
    case 1:
      return attn_f32_fwd(
          rows_f32::CellRows<__half>{static_cast<const __half*>(store), rows,
                                     Np, C},
          wv, qh, ws, part, rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H,
          G, normalize, wa, wb, stages, smem, stream, launched);
    case 2:
      return attn_f32_fwd(
          rows_f32::CellRows<int8_t>{static_cast<const int8_t*>(store), rows,
                                     Np, C},
          wv, qh, ws, part, rnorm, hsave, vatt, alpha, B, Np, n_valid, C, H,
          G, normalize, wa, wb, stages, smem, stream, launched);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
