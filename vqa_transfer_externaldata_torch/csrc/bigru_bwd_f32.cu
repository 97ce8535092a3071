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
//     not the zero start, in one launch (the chain on blockIdx.z);
//  4. both chains' db_hn in one launch of gru_step_f32.cuh's sum.
// 4 launches a call at any T (5 with one chain a launch). Where not even
// one chain's row of unit tiles fits (past ~1013 units, or the block's
// shared memory), the wrapper (ops/kernels.py::gru_f32_route) takes the
// step form, bigru_bwd_f32_step: two launches a step for both chains (the
// step kernel's BPTT form, which recomputes gh, then dh_prev = dpart +
// g_t @ U_h^T on fp32_tile.cuh's pair_product_kernel, but after the last
// step), then 3 on fp32_tile.cuh's loop and 4: 2T + 1 launches. Each
// chain's sums are K3f's, one FFMA chain each, k ascending, so each
// direction equals a K3f call bit for bit and both forms give the same
// bits. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"

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

// One chain's operands and scratch of the step form.
struct Chain {
  const float* gx;    // [T, B, 3H]
  const float* hseq;  // [T, B, H], K6f's
  const float* uh;    // [H, 3H]
  const float* bhn;   // [H]
  float* dh;          // [2, B, H] ping-pong, dh[0] the cotangent of hT
  float* dpart;       // [B, H]
  float* gq;          // [T, B, 3H]
  float* dgx;         // [T, B, 3H]
};

// Step s of both chains' BPTT: blockIdx.z 0 the forward chain at
// t = T-1-s, 1 the backward chain at t = s.
__global__ void __launch_bounds__(fp32_tile::THREADS)
    bigru_f32_bptt_kernel(Chain fwd, Chain bwd, const int* __restrict__ lens,
                          int s, int T, int B, int H) {
  __shared__ fp32_tile::Smem<gru_f32::BM, gru_f32::BN, gru_f32::BK> sm;
  const bool rev = blockIdx.z == 1;
  const Chain c = rev ? bwd : fwd;
  const int t = rev ? s : T - 1 - s;
  const bool first = rev ? t == T - 1 : t == 0;
  const long long BH = (long long)B * H, BH3 = 3 * BH;
  const float* hprev =
      first ? nullptr : c.hseq + (rev ? t + 1 : t - 1) * BH;
  gru_f32::step<true>(c.gx + t * BH3, hprev, lens, t, c.uh, c.bhn, B, H,
                      nullptr, nullptr, c.dh + (s % 2) * BH, c.dgx + t * BH3,
                      c.gq + t * BH3, c.dpart, sm);
}

// The db_hn sums of both chains, one launch: the column sums of each g's
// n-gate block over its T B rows.
cudaError_t dbhn_pair(const float* gqf, const float* gqb, float* dbhn,
                      int rows, int H, cudaStream_t stream, int* launched) {
  gru_f32::gru_f32_dbhn_kernel<<<dim3((H + 31) / 32, 2),
                                 dim3(32, gru_f32::SUM_ROWS), 0, stream>>>(
      gqf, dbhn, gqb, dbhn + H, rows, H);
  ++*launched;
  return cudaGetLastError();
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
// those rows and g's; a plan that either chain's alignment does not allow
// is refused with cudaErrorInvalidValue. The chains' cooperative launches
// take at most z (1 or 2) chains each, as bigru_fwd_f32's. 4 launches on
// `stream` (5 where the chains take a launch each), added to *launched;
// the chains' launch returns cudaErrorCooperativeLaunchTooLarge where not
// even one chain's grid can be resident (ops/kernels.py::gru_f32_route
// sends such shapes to bigru_bwd_f32_step).
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
        !fp32_ring::plan_ok<float, false>(wa_duh, wb_duh, stages, smem_duh,
                                          hp, (long long)H * 4,
                                          d ? gpb : gpf, H3 * 4))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long ghs = static_cast<long long>(std::max(T - 1, 1)) * BH3;
  cudaError_t err = gru_seq_f32::gh_launch(
      gru_seq_f32::GhChain{hpf, uhf, gh},
      gru_seq_f32::GhChain{hpb, uhb, gh + ghs}, 2, M, H, wa, wb, smem_gh,
      stream, launched);
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
  err = fp32_ring::by_plan(wa_duh, wb_duh, [&](auto fa, auto fb) {
    auto* kernel = gru_seq_f32::gru_f32_duh_kernel<decltype(fa)::value,
                                                    decltype(fb)::value>;
    cudaError_t e = fp32_ring::opt_in(kernel, smem_duh);
    if (e != cudaSuccess) return e;
    const int tile = fp32_ring::TILE;
    const dim3 grid((3 * H + tile - 1) / tile, (H + tile - 1) / tile, 2);
    kernel<<<grid, fp32_ring::THREADS, smem_duh, stream>>>(
        gru_seq_f32::DuhChain{hpf, gpf, duh},
        gru_seq_f32::DuhChain{hpb, gpb, duh + H * H3}, M, H, wa_duh, wb_duh);
    ++*launched;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dbhn_pair(gqf, gqb, dbhn, T * B, H, stream,
                                    launched));
}

// The step form: dh [2, 2, B, H] f32 with dh[d][0] = the cotangent of
// chain d's hT (overwritten) in place of ghTf, ghTb and no gh scratch;
// otherwise bigru_bwd_f32's arguments but z and the ring plans. 2T + 1
// launches on `stream`, added to *launched.
int bigru_bwd_f32_step(const float* gxf, const float* gxb, const float* hseqf,
                       const float* hseqb, const int* lens, const float* uhf,
                       const float* uhb, const float* bhnf, const float* bhnb,
                       float* dh, float* dpart, float* gq, float* dgx,
                       float* duh, float* dbhn, int T, int B, int H,
                       cudaStream_t stream, int* launched) {
  using fp32_tile::Dense;
  using fp32_tile::DenseT;
  const long long BH = (long long)B * H, H3 = 3LL * H, BH3 = 3 * BH;
  const Chain fwd{gxf, hseqf, uhf, bhnf, dh, dpart, gq, dgx};
  const Chain bwd{gxb, hseqb, uhb, bhnb, dh + 2 * BH, dpart + BH,
                  gq + T * BH3, dgx + T * BH3};
  const dim3 step_grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                       (B + gru_f32::BM - 1) / gru_f32::BM, 2);
  constexpr int DH_TILE = 32, DUH_TILE = 64;
  const dim3 dh_grid((H + DH_TILE - 1) / DH_TILE,
                     (B + DH_TILE - 1) / DH_TILE, 2);
  cudaError_t err;
  for (int s = 0; s < T; ++s) {
    bigru_f32_bptt_kernel<<<step_grid, fp32_tile::THREADS, 0, stream>>>(
        fwd, bwd, lens, s, T, B, H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    if (s == T - 1) break;  // the chains' starts: no dh_prev is read
    const int tf = T - 1 - s, tb = s;
    fp32_tile::pair_product_kernel<DH_TILE, DH_TILE, 32, true, true>
        <<<dh_grid, fp32_tile::THREADS, 0, stream>>>(
            Dense{fwd.gq + tf * BH3, H3}, DenseT{uhf, H3}, fwd.dpart,
            fwd.dh + ((s + 1) % 2) * BH, Dense{bwd.gq + tb * BH3, H3},
            DenseT{uhb, H3}, bwd.dpart, bwd.dh + ((s + 1) % 2) * BH, B, H,
            int(H3), H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // Rows of live h_prev: forward, hseqf[0 .. T-2] against g[1 .. T-1];
  // backward, hseqb[1 .. T-1] against g[0 .. T-2].
  const int K = (T - 1) * B;
  const dim3 duh_grid((3 * H + DUH_TILE - 1) / DUH_TILE,
                      (H + DUH_TILE - 1) / DUH_TILE, 2);
  fp32_tile::pair_product_kernel<DUH_TILE, DUH_TILE, 16, false, false>
      <<<duh_grid, fp32_tile::THREADS, 0, stream>>>(
          DenseT{hseqf, H}, Dense{fwd.gq + BH3, H3}, nullptr, duh,
          DenseT{hseqb + BH, H}, Dense{bwd.gq, H3}, nullptr, duh + H * H3, H,
          3 * H, K, H3);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      dbhn_pair(fwd.gq, bwd.gq, dbhn, T * B, H, stream, launched));
}

}  // extern "C"
