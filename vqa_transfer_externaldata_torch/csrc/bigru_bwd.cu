// K7 `bigru_bwd`: backpropagation through time of both recurrences of a
// bidirectional GRU, walked together, for Hopper (sm_90a). The same source
// builds K7h (csrc/bigru_bwd_f16.cu), the float16 instance: E = KernelElem
// (elem16.cuh), the type of U_h, of the copy of the pre-step states and of
// the staged gate cotangents, is bf16 here and float16 there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_bwd_kernel (the
// Pallas body launched by _bigru_pallas_bwd_call): grid step k walks the
// forward chain's BPTT down actual time (t = T-1-k, pre-step state
// hseqf[t-1], zero at t = 0) and the backward chain's up (t = k, pre-step
// state hseqb[t+1], zero at t = T-1). The step math is _gru_cell_bwd.
//
// What bounds it on an H100: at B=256, T=26, H=512 the three products of a
// live row-step (~17 GFLOP a direction, 35 us for both at the 16-bit peak)
// lose to the bytes: gx in and dgx out are 41 MB each a direction (~50 us
// for both at 3.35 TB/s). The real limit is, as for K3, the latency of 26
// dependent steps.
//
// Design: K3's kernels (gru_bwd_step.cuh) with the direction on blockIdx.z.
// One cooperative launch of the persistent step kernel walks all T steps of
// both chains, one grid barrier a step for both: at B=256, H=512 that is 32
// j-tiles x 2 rows x 2 directions, 128 blocks, one an SM, each holding its
// direction's U_h slices in shared memory and walking 2 of the 4 b-tiles a
// step (ops/kernels.py::gru_bwd_plan fits both directions' j-tiles on the
// card). Then one launch of the pipelined dU_h GEMM and one of the db_hn
// sum for both directions: 3 launches a call, whatever T. Each direction's
// outputs equal a K3 call with the same `reverse` bit for bit. No atomics:
// the result is deterministic.

#include "gru_bwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As gru_bwd_config (csrc/gru_bwd.cu), for this library's instance of the
// persistent step kernel.
int bigru_bwd_config(int H, int* per_sm, long long* smem_bytes,
                     int* max_width) {
  size_t smem = 0;
  const cudaError_t e =
      bptt_occupancy<KernelElem>(H, per_sm, &smem, max_width);
  if (e != cudaSuccess) cudaGetLastError();
  *smem_bytes = static_cast<long long>(smem);
  return static_cast<int>(e);
}

// gxf, gxb [T, B, 3H] f32, hseqf, hseqb [T, B, H] f32 (K6's residuals),
// lens [B] i32, uhf, uhb [H, 3H] E, bhnf, bhnb [H] f32; dhe [2, B, H] f32
// holds the cotangents of the two final states on entry (forward chain
// first) and is clobbered. Scratch: g [2, T, B, 3H] E,
// part [2, T, ceil(B/16), H] f32, hbf [2, T, B, H] E. Outputs, forward
// chain first: dgx [2, T, B, 3H], duh [2, H, 3H], dbhn [2, H], all f32.
// `rows` rows of blocks for each direction, as ops/kernels.py::gru_bwd_plan
// chooses them. Needs H % 64 == 0 (checked by the caller). Launches the
// persistent step kernel (cooperatively), the dU_h GEMM and the db_hn sum
// of both directions on `stream` (3), counting in *launched those that
// launched; returns the first error (bptt_run).
int bigru_bwd(const void* gxf, const void* gxb, const void* hseqf,
              const void* hseqb, const void* lens, const void* uhf,
              const void* uhb, const void* bhnf, const void* bhnb, void* dhe,
              void* dgx, void* g, void* part, void* duh, void* dbhn,
              void* hbf, int T, int B, int H, int rows, void* stream,
              int* launched) {
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t seq_h = T * step_h;
  const size_t seq_gx = 3 * seq_h;
  const size_t seq_part =
      static_cast<size_t>(T) * ((B + kTile - 1) / kTile) * H;
  const int* ln = static_cast<const int*>(lens);
  float* const dh = static_cast<float*>(dhe);
  float* const dg = static_cast<float*>(dgx);
  using E = KernelElem;
  E* const gs = static_cast<E*>(g);
  float* const pt = static_cast<float*>(part);
  E* const hb = static_cast<E*>(hbf);
  const Bptt<E> f{static_cast<const float*>(gxf),
                  static_cast<const float*>(hseqf), hb, ln,
                  static_cast<const E*>(uhf),
                  static_cast<const float*>(bhnf), dh, dg, gs, pt, T, B, H,
                  0};
  const Bptt<E> b{static_cast<const float*>(gxb),
                  static_cast<const float*>(hseqb), hb + seq_h, ln,
                  static_cast<const E*>(uhb),
                  static_cast<const float*>(bhnb), dh + step_h, dg + seq_gx,
                  gs + seq_gx, pt + seq_part, T, B, H, 1};
  float* const du = static_cast<float*>(duh);
  float* const db = static_cast<float*>(dbhn);
  return bptt_run<E>({f, b}, {du, du + static_cast<size_t>(H) * 3 * H},
                     {db, db + H}, 2, rows, static_cast<cudaStream_t>(stream),
                     launched);
}

}  // extern "C"
