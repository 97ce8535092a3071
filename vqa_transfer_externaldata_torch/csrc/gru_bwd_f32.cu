// K3f `gru_bwd_f32`: the BPTT of K1f's float32 recurrence, for Hopper
// (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel (the
// Pallas body launched by _gru_fused_bwd) when the model computes in
// float32: the TPU kernel takes U_h in the model's dtype, and K3
// (gru_bwd.cu) takes only bf16. The same function as gru_bwd_reference on
// float32 U_h: from the carried dh, each step's dgx_t, and the sums dU_h
// (over every step's h_prev^T g_t) and db_hn, which the TPU kernel forms
// in its own body and so does this kernel, not a library call.
//
// What bounds it on an H100: at B=256, H=512, T=26 it recomputes the
// hidden products, carries dh through U_h^T and forms dU_h, each at most
// 10.1 GFLOP over the 25 x 256 row-steps whose carry is not the zero
// start: 30.2 GFLOP of f32 FFMA, 0.45 ms at 67 TFLOP/s, against ~100 MB
// of reads and writes: the FP32 pipes and the shared-memory loads that
// feed them, and the T dependent steps of the carry.
//
// Design, launches in stream order (gru_seq_f32.cuh):
//  1. gh = h_prev @ U_h for every step but the chain's first (whose h_prev
//     is the zero start) in one product over the (T-1) B saved states,
//     gru_f32_gh_kernel on fp32_ring.cuh's tile loop (its plan from
//     ops/kernels.py::f32_ring_plan), into a [T-1, B, 3H] scratch: the
//     recompute is off the chain;
//  2. the chain, one cooperative launch (gru_f32_bptt_kernel): each block
//     keeps U_h's rows of its 16 units in shared memory, and every step
//     forms dh = dpart + g_{t+-1} @ U_h^T for its units from the g rows
//     that every block wrote before the grid barrier, streamed through a
//     cp.async ring, then the gate backward, writing dgx_t, g_t and dpart;
//  3. dU_h = h_prev^T g over the (T-1) B rows whose h_prev is not the zero
//     start: hseq and g read in place, shifted by one step, on
//     fp32_ring.cuh's loop (gru_f32_duh_kernel, K7f's), each sum over all
//     rows in order;
//  4. db_hn = the column sums of g's n-gate block over the T B rows, eight
//     row strides a unit added in a fixed order (gru_step_f32.cuh).
// 4 launches a call at any T. Where the chain does not fit, the wrapper
// takes the step form, gru_bwd_f32_step (gru_bptt_f32.cuh): the lists of
// each step's live rows, every live row-step's gh in one product, one
// launch a step that carries dh through U_h^T for the step's live rows and
// runs their gate backward, then dU_h over the live row-steps and db_hn:
// T + 4 launches. Every sum of both forms is one FFMA chain in the same
// order and the gate math is shared, so their outputs are equal bit for
// bit. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"
#include "gru_bptt_f32.cuh"

namespace {

using gru_seq_f32::BwdArgs;

using gru_seq_f32::BwdTile;
using BwdKernel = void (*)(BwdArgs);

// The chain's instance at width H: 16-byte copies of g where its rows are
// 16-byte aligned.
BwdKernel bwd_kernel(int H) {
  return H % 4 == 0 ? gru_seq_f32::gru_f32_bptt_kernel<BwdTile, true>
                    : gru_seq_f32::gru_f32_bptt_kernel<BwdTile, false>;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The chain's persistent launch at batch B and width H on the current
// device, as gru_fwd_f32_config reports K1f's.
int gru_bwd_f32_config(int B, int H, int* grid, int* per_sm,
                       long long* smem_bytes) {
  return gru_seq_f32::persist_config<BwdTile>(
      bwd_kernel(H), gru_seq_f32::bwd_smem(H), B, H, 1, grid, per_sm,
      smem_bytes);
}

// gx [T, B, 3H], hseq [T, B, H] (K1f's), lens [B] i32, uh [H, 3H], bhn
// [H], ghT [B, H] (the cotangent of hT) f32; scratch dpart [B, H], gq
// [T, B, 3H], gh [max(T-1, 1), B, 3H] -> dgx [T, B, 3H], duh [H, 3H], dbhn
// [H], all f32. The ring plans are the wrapper's
// ops/kernels.py::f32_ring_plan: (wa, wb, stages, smem_gh) of the gh
// product over hseq's rows of live h_prev and U_h, (wa_duh, wb_duh,
// smem_duh) of the dU_h product over those rows and g's, refused with
// cudaErrorInvalidValue where their alignment does not allow it. 4
// launches on `stream`, added to *launched; the chain's cooperative launch
// returns cudaErrorCooperativeLaunchTooLarge where its grid cannot be
// resident (ops/kernels.py::gru_f32_route sends such shapes to
// gru_bwd_f32_step).
int gru_bwd_f32(const float* gx, const float* hseq, const int* lens,
                const float* uh, const float* bhn, const float* ghT,
                float* dpart, float* gq, float* gh, float* dgx, float* duh,
                float* dbhn, int T, int B, int H, int reverse, int wa,
                int wb, int stages, int smem_gh, int wa_duh, int wb_duh,
                int smem_duh, cudaStream_t stream, int* launched) {
  const long long BH = (long long)B * H, BH3 = 3 * BH;
  const int M = (T - 1) * B;
  // The saved states of live h_prev (hseq itself at T = 1: no rows) and g
  // of the steps they precede: forward hseq[0 .. T-2] against g[1 .. T-1],
  // reverse hseq[1 .. T-1] against g[0 .. T-2].
  const float* hp = hseq + (reverse && M > 0 ? BH : 0);
  const float* gp = gq + (!reverse && M > 0 ? BH3 : 0);
  if (T < 1 || B < 1 || H < 1 ||
      !fp32_ring::plan_ok<float, true>(wa, wb, stages, smem_gh, hp,
                                       (long long)H * 4, uh,
                                       3LL * H * 4) ||
      !fp32_ring::plan_ok<float, false, true>(wa_duh, wb_duh, stages,
                                              smem_duh, hp, (long long)H * 4,
                                              gp, 3LL * H * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const gru_seq_f32::GhChain g{hp, uh, gh, nullptr, nullptr};
  cudaError_t err = gru_seq_f32::gh_launch(g, g, 1, M, H, wa, wb, smem_gh,
                                           stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gru_seq_f32::BwdChain c{gx, gh, hseq, uh, bhn, ghT, dpart, gq, dgx,
                                reverse};
  const BwdArgs a{{c, c}, lens, T, B, H};
  const int rc = gru_seq_f32::persist_launch<BwdTile>(
      bwd_kernel(H), gru_seq_f32::bwd_smem(H), a, B, H, 1, 1, stream,
      launched);
  if (rc != 0) return rc;
  const gru_seq_f32::DuhChain d{hp, gp, duh, nullptr, nullptr};
  err = gru_seq_f32::duh_launch(d, d, 1, M, H, wa_duh, wb_duh, smem_duh,
                                stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gru_f32::dbhn_launch(
      gq, dbhn, nullptr, nullptr, 1, T * B, H, stream, launched));
}

// The step form (gru_bptt_f32.cuh): dpart [B, H] holds the cotangent of hT
// on entry (in place of ghT); lists an int32 scratch of
// gru_bptt_f32::StepLists<int>::ints(T, B) (ops/kernels.py::
// gru_f32_lists_ints); gh [max(T-1, 1) B, 3H] takes the live row-steps'
// gh, packed; tu the carry's units a thread (ops/kernels.py::
// gru_f32_carry_plan); the ring plans as gru_bwd_f32's, the dU_h one over
// rows through an index. T + 4 launches on `stream`, added to *launched.
int gru_bwd_f32_step(const float* gx, const float* hseq, const int* lens,
                     const float* uh, const float* bhn, float* dpart,
                     int* lists, float* gh, float* gq, float* dgx,
                     float* duh, float* dbhn, int T, int B, int H,
                     int reverse, int tu, int wa, int wb, int stages,
                     int smem_gh, int wa_duh, int wb_duh, int smem_duh,
                     cudaStream_t stream, int* launched) {
  const gru_bptt_f32::Chain c{gx,  hseq, uh,  bhn,  dpart,  gh,
                              gq,  dgx,  duh, dbhn, reverse};
  const gru_bptt_f32::Plans pl{tu, wa, wb, stages, smem_gh, wa_duh, wb_duh,
                               smem_duh};
  return static_cast<int>(gru_bptt_f32::launch_step_form(
      c, c, 1, lens, lists, T, B, H, pl, stream, launched));
}

}  // extern "C"
