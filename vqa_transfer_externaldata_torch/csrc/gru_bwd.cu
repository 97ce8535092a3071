// K3 `gru_bwd`: backpropagation through time of the fused GRU recurrence,
// for Hopper (sm_90a). The same source builds K3h (csrc/gru_bwd_f16.cu),
// the float16 instance: E = KernelElem (elem16.cuh) is bf16 here and
// float16 there, the type of U_h, of the copy of the pre-step states and of
// the staged gate cotangents.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel (the
// Pallas body launched by _gru_pallas_bwd_call); the step math is that
// file's _gru_cell_bwd. The kernels and their launch are gru_bwd_step.cuh's,
// which K7 (csrc/bigru_bwd.cu) runs on both directions of a bidirectional
// GRU: here on one direction, so each of K7's directions equals a K3 call
// bit for bit.
//
// What bounds it on an H100: at B=256, T=26, H=512 the three products of a
// live row-step (gh, the U_h^T product, dU_h) are 6 * H * 3H operations
// each, about 17 GFLOP over the ~3700 live row-steps of a batch (18 us at
// 989 TFLOP/s), while dgx and gx alone are 2 x 41 MB of f32 (25 us at
// 3.35 TB/s): the bytes bound it. The real limit is the latency of 26
// dependent steps, each of which needs every block's gate cotangents of the
// step before.
//
// Design (gru_bwd_step.cuh): one cooperative launch of the persistent step
// kernel for all T steps, 32 j-tiles x 4 rows of 64-row b-tile blocks at
// B=256, H=512, one block an SM with U_h's slices resident in shared
// memory; then the pipelined dU_h GEMM and the fixed-order db_hn sum: 3
// launches a call. No atomics: the result is deterministic.

#include "gru_bwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The persistent step kernel's resident blocks per SM at width H (0 where
// its shared memory does not fit), its dynamic shared memory in bytes and
// the widest H that fits, on the current device. Returns the CUDA error of
// the queries, clearing it from the runtime.
int gru_bwd_config(int H, int* per_sm, long long* smem_bytes,
                   int* max_width) {
  size_t smem = 0;
  const cudaError_t e =
      bptt_occupancy<KernelElem>(H, per_sm, &smem, max_width);
  if (e != cudaSuccess) cudaGetLastError();
  *smem_bytes = static_cast<long long>(smem);
  return static_cast<int>(e);
}

// gx_t [T, B, 3H] f32, hseq [T, B, H] f32 (K1's residual), lens [B] i32,
// uh [H, 3H] E, bhn [H] f32; dhe [B, H] f32 holds the cotangent of the
// final state on entry and is clobbered. Scratch: g [T, B, 3H] E,
// part [T, ceil(B/16), H] f32, hbf [T, B, H] E. Outputs: dgx
// [T, B, 3H], duh [H, 3H], dbhn [H], all f32. `rows` rows of blocks, as
// ops/kernels.py::gru_bwd_plan chooses them. Needs H % 64 == 0 (checked by
// the caller). Launches the persistent step kernel (cooperatively), the
// dU_h GEMM and the db_hn sum on `stream` (3), counting in *launched those
// that launched; returns the first error (bptt_run).
int gru_bwd(const void* gx_t, const void* hseq, const void* lens,
            const void* uh, const void* bhn, void* dhe, void* dgx, void* g,
            void* part, void* duh, void* dbhn, void* hbf, int T, int B,
            int H, int reverse, int rows, void* stream, int* launched) {
  using E = KernelElem;
  const Bptt<E> p{static_cast<const float*>(gx_t),
                  static_cast<const float*>(hseq),
                  static_cast<E*>(hbf),
                  static_cast<const int*>(lens),
                  static_cast<const E*>(uh),
                  static_cast<const float*>(bhn),
                  static_cast<float*>(dhe),
                  static_cast<float*>(dgx),
                  static_cast<E*>(g),
                  static_cast<float*>(part),
                  T, B, H, reverse};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return bptt_run<E>({p, p}, {du, du}, {db, db}, 1, rows,
                     static_cast<cudaStream_t>(stream), launched);
}

}  // extern "C"
