// K7f `bigru_bwd_f32`: the BPTT of both chains of K6f's float32
// bidirectional recurrence, walked together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_bwd_kernel (the
// Pallas body launched by _bigru_pallas_bwd_call) when the model computes
// in float32: the TPU kernel takes U_h in the model's dtype, and K7
// (bigru_bwd.cu) takes only bf16. The same function as bigru_bwd_reference
// on float32 U_h: step s walks the forward chain's BPTT down actual time
// (t = T-1-s, pre-step state hseqf[t-1], zero at t = 0) and the backward
// chain's up (t = s, pre-step state hseqb[t+1], zero at t = T-1); then each
// chain's dU_h (over every step's h_prev^T g_t) and db_hn.
//
// What bounds it on an H100 SXM (peak rates at its 700 W limit): at
// B=256, H=512, T=26 each chain recomputes its hidden products, carries dh
// through U_h^T and forms dU_h, each at most 10.1 GFLOP over the 25 x 256
// row-steps whose carry is not the zero start: 60.4 GFLOP of f32 FFMA for
// both (0.90 ms at 67 TFLOP/s; the bound counts this run's carried
// row-steps), against ~200 MB of reads and writes: the FP32 pipes and the
// shared-memory loads that feed them, and the T dependent steps of the
// chains. PERF.md has its time and its four launches' beside two K3f
// calls on an H100 80GB HBM3 at 700 W.
//
// Design: K3f's four launches (csrc/gru_bwd_f32.cu, gru_seq_f32.cuh), each
// taking both chains, in stream order:
//  1. every step's gh of both chains in one product on fp32_ring.cuh's
//     loop (gru_f32_gh_kernel, the chain on blockIdx.z), each chain over
//     its own saved states of live h_prev (forward hseqf[0 .. T-2],
//     backward hseqb[1 .. T-1]), into a [2, T-1, B, 3H] scratch: the
//     recompute is off the chains;
//  2. both chains' BPTT in one cooperative launch (gru_f32_bptt_kernel,
//     the chain on blockIdx.z): block (jx, by, d) keeps chain d's 16 U_h
//     rows resident and reads g through the 4-stage ring, one grid barrier
//     a step for both (one launch a chain where a row of both chains' unit
//     tiles cannot be resident at once but one chain's can);
//  3. both chains' dU_h = h_prev^T g over the (T-1) B rows whose h_prev is
//     not the zero start, in one launch (gru_f32_duh_kernel, the chain on
//     blockIdx.z);
//  4. both chains' db_hn in one launch of gru_step_f32.cuh's sum.
// 4 launches a call at any T (5 with one chain a launch). Where not even
// one chain's row of unit tiles fits (past ~1013 units, or the block's
// shared memory), the wrapper (ops/kernels.py::gru_f32_route) takes the
// step form, bigru_bwd_f32_step: K3f's (gru_bptt_f32.cuh) with both chains
// in each launch, the lists of live rows shared: T + 4 launches. Each
// chain's sums are K3f's, one FFMA chain each, k ascending, so each
// direction equals a K3f call bit for bit and both forms give the same
// bits. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"
#include "gru_bptt_f32.cuh"

namespace {

using gru_seq_f32::BwdArgs;
using gru_seq_f32::BwdChain;
using gru_seq_f32::BwdTile;
using BwdKernel = void (*)(BwdArgs);

// K3f's chain instance at width H (gru_bwd_f32.cu's choice).
BwdKernel bwd_kernel(int H) {
  return H % 4 == 0 ? gru_seq_f32::gru_f32_bptt_kernel<BwdTile, true>
                    : gru_seq_f32::gru_f32_bptt_kernel<BwdTile, false>;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The persistent chain launch of both chains at batch B and width H on the
// current device, as bigru_fwd_f32_config reports K6f's.
int bigru_bwd_f32_config(int B, int H, int* grid, int* per_sm,
                         long long* smem_bytes) {
  return gru_seq_f32::persist_config<BwdTile>(
      bwd_kernel(H), gru_seq_f32::bwd_smem(H), B, H, 2, grid, per_sm,
      smem_bytes);
}

// gxf, gxb [T, B, 3H], hseqf, hseqb [T, B, H] (K6f's), lens [B] i32, uhf,
// uhb [H, 3H], bhnf, bhnb [H], ghTf, ghTb [B, H] (the cotangents of the
// final states) f32; scratch dpart [2, B, H], gq [2, T, B, 3H], gh [2,
// max(T-1, 1), B, 3H] -> dgx [2, T, B, 3H], duh [2, H, 3H], dbhn [2, H],
// all f32, the forward chain first. The ring plans (copy widths in bytes,
// stages, shared bytes) are the wrapper's ops/kernels.py::f32_ring_plan:
// (wa, wb, stages, smem_gh) of the gh product over both chains' live
// h_prev rows and U_h, (wa_duh, wb_duh, smem_duh) of the dU_h product over
// those rows and g's (rows through an index); a plan that either chain's
// alignment does not allow is refused with cudaErrorInvalidValue. The
// chains' cooperative launches take at most z (1 or 2) chains each, as
// bigru_fwd_f32's. 4 launches on `stream` (5 where the chains take a
// launch each), added to *launched; the chains' launch returns
// cudaErrorCooperativeLaunchTooLarge where not even one chain's grid can
// be resident (ops/kernels.py::gru_f32_route sends such shapes to
// bigru_bwd_f32_step).
int bigru_bwd_f32(const float* gxf, const float* gxb, const float* hseqf,
                  const float* hseqb, const int* lens, const float* uhf,
                  const float* uhb, const float* bhnf, const float* bhnb,
                  const float* ghTf, const float* ghTb, float* dpart,
                  float* gq, float* gh, float* dgx, float* duh, float* dbhn,
                  int T, int B, int H, int z, int wa, int wb, int stages,
                  int smem_gh, int wa_duh, int wb_duh, int smem_duh,
                  cudaStream_t stream, int* launched) {
  const long long BH = (long long)B * H, H3 = 3LL * H, BH3 = 3 * BH;
  const int M = (T - 1) * B;
  // The saved states of live h_prev: forward hseqf[0 .. T-2], backward
  // hseqb[1 .. T-1] (hseqb itself at T = 1: no rows), against g of the
  // steps they precede: forward gq[1 .. T-1], backward gq[0 .. T-2].
  const float* hpf = hseqf;
  const float* hpb = hseqb + (M > 0 ? BH : 0);
  float* gqf = gq;
  float* gqb = gq + T * BH3;
  const float* gpf = gqf + (M > 0 ? BH3 : 0);
  const float* gpb = gqb;
  if (T < 1 || B < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < 2; ++d) {
    const float* hp = d == 0 ? hpf : hpb;
    if (!fp32_ring::plan_ok<float, true>(wa, wb, stages, smem_gh, hp,
                                         (long long)H * 4, d ? uhb : uhf,
                                         H3 * 4) ||
        !fp32_ring::plan_ok<float, false, true>(wa_duh, wb_duh, stages,
                                                smem_duh, hp,
                                                (long long)H * 4,
                                                d ? gpb : gpf, H3 * 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ghs = static_cast<long long>(std::max(T - 1, 1)) * BH3;
  cudaError_t err = gru_seq_f32::gh_launch(
      gru_seq_f32::GhChain{hpf, uhf, gh, nullptr, nullptr},
      gru_seq_f32::GhChain{hpb, uhb, gh + ghs, nullptr, nullptr}, 2, M, H,
      wa, wb, smem_gh, stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{{BwdChain{gxf, gh, hseqf, uhf, bhnf, ghTf, dpart, gqf, dgx,
                            0},
                   BwdChain{gxb, gh + ghs, hseqb, uhb, bhnb, ghTb,
                            dpart + BH, gqb, dgx + T * BH3, 1}},
                  lens, T, B, H};
  const int rc = gru_seq_f32::persist_launch<BwdTile>(
      bwd_kernel(H), gru_seq_f32::bwd_smem(H), a, B, H, 2, z, stream,
      launched);
  if (rc != 0) return rc;
  err = gru_seq_f32::duh_launch(
      gru_seq_f32::DuhChain{hpf, gpf, duh, nullptr, nullptr},
      gru_seq_f32::DuhChain{hpb, gpb, duh + H * H3, nullptr, nullptr}, 2, M,
      H, wa_duh, wb_duh, smem_duh, stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gru_f32::dbhn_launch(gqf, dbhn, gqb, dbhn + H, 2,
                                               T * B, H, stream, launched));
}

// The step form: dpart [2, B, H] holds the cotangents of hTf and hTb on
// entry (in place of ghTf, ghTb); lists, gh [2, max(T-1, 1) B, 3H] and tu
// as gru_bwd_f32_step's (the lists serve both chains); otherwise
// bigru_bwd_f32's arguments but z. T + 4 launches on `stream`, added to
// *launched.
int bigru_bwd_f32_step(const float* gxf, const float* gxb, const float* hseqf,
                       const float* hseqb, const int* lens, const float* uhf,
                       const float* uhb, const float* bhnf, const float* bhnb,
                       float* dpart, int* lists, float* gh, float* gq,
                       float* dgx, float* duh, float* dbhn, int T, int B,
                       int H, int tu, int wa, int wb, int stages,
                       int smem_gh, int wa_duh, int wb_duh, int smem_duh,
                       cudaStream_t stream, int* launched) {
  const long long BH = (long long)B * H, H3 = 3LL * H, BH3 = 3 * BH;
  const long long ghs = static_cast<long long>(std::max(T - 1, 1)) * BH3;
  const gru_bptt_f32::Chain f{gxf, hseqf, uhf, bhnf, dpart, gh, gq, dgx,
                              duh, dbhn, 0};
  const gru_bptt_f32::Chain b{gxb,        hseqb,          uhb,
                              bhnb,       dpart + BH,     gh + ghs,
                              gq + T * BH3, dgx + T * BH3, duh + H * H3,
                              dbhn + H,   1};
  const gru_bptt_f32::Plans pl{tu, wa, wb, stages, smem_gh, wa_duh, wb_duh,
                               smem_duh};
  return static_cast<int>(gru_bptt_f32::launch_step_form(
      f, b, 2, lens, lists, T, B, H, pl, stream, launched));
}

}  // extern "C"
