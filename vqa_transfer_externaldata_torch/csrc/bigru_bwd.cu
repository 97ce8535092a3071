// K7 `bigru_bwd`: backpropagation through time of both recurrences of a
// bidirectional GRU, walked together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_bwd_kernel (the
// Pallas body launched by _bigru_pallas_bwd_call): grid step k walks the
// forward chain's BPTT down actual time (t = T-1-k, pre-step state
// hseqf[t-1], zero at t = 0) and the backward chain's up (t = k, pre-step
// state hseqb[t+1], zero at t = T-1). The step math is _gru_cell_bwd, in
// the kernels of gru_bwd_step.cuh, which K3 runs too: each direction's
// gradients equal a K3 call on its own inputs.
//
// What bounds it on an H100: at B=256, T=26, H=512 the three products of a
// live row-step (~17 GFLOP a direction, 35 us for both at the bf16 peak)
// lose to the bytes: gx in and dgx out are 41 MB each a direction (~50 us
// for both at 3.35 TB/s). The real limit is, as for K3, the latency of 26
// dependent steps.
//
// Design: K3's kernels with a direction axis. Launch k of the step kernel
// holds both chains' tiles (blockIdx.z), so the sequence takes T step
// launches where two K3 calls take 2T; the dU_h GEMM of both directions is
// one launch (blockIdx.z), and so is the fixed-order db_hn sum
// (blockIdx.y). No atomics: the result is deterministic.

#include "gru_bwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gxf, gxb [T, B, 3H] f32, hseqf, hseqb [T, B, H] f32 (K6's residuals),
// lens [B] i32, uhf, uhb [H, 3H] bf16, bhnf, bhnb [H] f32; dhe [2, B, H] f32
// holds the cotangents of the two final states on entry (forward chain
// first) and is clobbered. Scratch: g [2, T, B, 3H] bf16,
// part [2, T, ceil(B/16), H] f32. Outputs, forward chain first: dgx
// [2, T, B, 3H], duh [2, H, 3H], dbhn [2, H], all f32. Needs H % 64 == 0
// (checked by the caller). Launches T step kernels, the dU_h GEMM and the
// db_hn sum on `stream` (T + 2), counting in *launched those that
// launched; returns the first error.
int bigru_bwd(const void* gxf, const void* gxb, const void* hseqf,
              const void* hseqb, const void* lens, const void* uhf,
              const void* uhb, const void* bhnf, const void* bhnb, void* dhe,
              void* dgx, void* g, void* part, void* duh, void* dbhn, int T,
              int B, int H, void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = prepare_bwd_step_kernel(H);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = step_smem_bytes(H);
  const int nbt = (B + kTile - 1) / kTile;
  const dim3 grid(H / kTile, nbt, 2);
  const size_t step_gx = static_cast<size_t>(B) * 3 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t part_step = static_cast<size_t>(nbt) * H;
  const float* hsf = static_cast<const float*>(hseqf);
  const float* hsb = static_cast<const float*>(hseqb);
  float* dhef = static_cast<float*>(dhe);
  float* dheb = dhef + step_h;
  float* dgxf = static_cast<float*>(dgx);
  float* dgxb = dgxf + T * step_gx;
  __nv_bfloat16* gf = static_cast<__nv_bfloat16*>(g);
  __nv_bfloat16* gb = gf + T * step_gx;
  float* partf = static_cast<float*>(part);
  float* partb = partf + T * part_step;
  for (int k = 0; k < T; ++k) {
    const int tf = T - 1 - k;  // forward chain: descending actual time
    const int tb = k;          // backward chain: ascending
    const BwdStep f{
        static_cast<const float*>(gxf) + tf * step_gx,
        tf == 0 ? nullptr : hsf + (tf - 1) * step_h,
        static_cast<const __nv_bfloat16*>(uhf),
        static_cast<const float*>(bhnf),
        k == 0 ? nullptr : gf + (tf + 1) * step_gx, dhef,
        dgxf + tf * step_gx, gf + tf * step_gx, partf + k * part_step, tf};
    const BwdStep b{
        static_cast<const float*>(gxb) + tb * step_gx,
        tb == T - 1 ? nullptr : hsb + (tb + 1) * step_h,
        static_cast<const __nv_bfloat16*>(uhb),
        static_cast<const float*>(bhnb),
        k == 0 ? nullptr : gb + (tb - 1) * step_gx, dheb,
        dgxb + tb * step_gx, gb + tb * step_gx, partb + k * part_step, tb};
    gru_bwd_step_kernel<<<grid, kThreads, smem, st>>>(
        f, b, static_cast<const int*>(lens), B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
  }
  // Pre-step states: hseqf[t-1] for the forward chain's steps t = 1..T-1,
  // hseqb[t+1] for the backward chain's t = 0..T-2; each chain's first
  // processed step has the zero state, adds nothing and is left out.
  const int K = (T - 1) * B;
  float* duhf = static_cast<float*>(duh);
  const DuhGemm df{hsf, gf + step_gx, duhf};
  const DuhGemm db{hsb + step_h, gb, duhf + static_cast<size_t>(H) * 3 * H};
  gru_duh_kernel<<<dim3(3 * H / kGN, H / kGM, 2), kGThreads, 0, st>>>(
      df, db, K, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  float* dbhnf = static_cast<float*>(dbhn);
  const DbhnSum pf{partf, dbhnf};
  const DbhnSum pb{partb, dbhnf + H};
  gru_dbhn_kernel<<<dim3((H + 255) / 256, 2), 256, 0, st>>>(pf, pb, T * nbt,
                                                              H);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
