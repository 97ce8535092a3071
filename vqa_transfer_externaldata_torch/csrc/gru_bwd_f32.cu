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
//     fp32_tile.cuh's loop, 64 x 64 outputs a block, each sum over all rows
//     in order;
//  4. db_hn = the column sums of g's n-gate block over the T B rows, eight
//     row strides a unit added in a fixed order (gru_step_f32.cuh).
// 4 launches a call at any T. Where the chain does not fit, the wrapper
// takes the step form, gru_bwd_f32_step: two launches a step (the step
// kernel's BPTT form, which recomputes gh, then dh_prev = dpart + g_t @
// U_h^T on fp32_tile.cuh's loop, 32 x 32 outputs a block, but after the
// last step), then 3 and 4: 2T + 1 launches. Every sum of both forms is
// one FFMA chain in the same order and the gate math is shared, so their
// outputs are equal bit for bit. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"

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

// Steps 3 and 4 of both forms: dU_h over the rows of live h_prev and db_hn.
cudaError_t duh_dbhn(const float* hseq, const float* gq, float* duh,
                     float* dbhn, int T, int B, int H, int reverse,
                     cudaStream_t stream, int* launched) {
  constexpr int DUH_TILE = 64;
  const long long BH = (long long)B * H, H3 = 3LL * H;
  // Rows of live h_prev: forward, hseq[0 .. T-2] against g[1 .. T-1];
  // reverse, hseq[1 .. T-1] against g[0 .. T-2].
  const float* hp = hseq + (reverse ? BH : 0);
  const float* gp = gq + (reverse ? 0 : B * H3);
  const int K = (T - 1) * B;
  const dim3 duh_grid((3 * H + DUH_TILE - 1) / DUH_TILE,
                      (H + DUH_TILE - 1) / DUH_TILE);
  fp32_tile::product_kernel<DUH_TILE, DUH_TILE, 16, false, false>
      <<<duh_grid, fp32_tile::THREADS, 0, stream>>>(
          fp32_tile::DenseT{hp, H}, fp32_tile::Dense{gp, H3}, H, 3 * H, K, K,
          nullptr, duh, H3);
  ++*launched;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gru_f32::gru_f32_dbhn_kernel<<<(H + 31) / 32, dim3(32, gru_f32::SUM_ROWS),
                                 0, stream>>>(gq, dbhn, nullptr, nullptr,
                                              T * B, H);
  ++*launched;
  return cudaGetLastError();
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
// [H], all f32. The gh product's ring plan (copy widths wa, wb in bytes,
// stages, shared bytes smem_gh) is the wrapper's
// ops/kernels.py::f32_ring_plan of hseq's rows and U_h, refused with
// cudaErrorInvalidValue where their alignment does not allow it. 4
// launches on `stream`, added to *launched; the chain's cooperative launch
// returns cudaErrorCooperativeLaunchTooLarge where its grid cannot be
// resident (ops/kernels.py::gru_f32_route sends such shapes to
// gru_bwd_f32_step).
int gru_bwd_f32(const float* gx, const float* hseq, const int* lens,
                const float* uh, const float* bhn, const float* ghT,
                float* dpart, float* gq, float* gh, float* dgx, float* duh,
                float* dbhn, int T, int B, int H, int reverse, int wa,
                int wb, int stages, int smem_gh, cudaStream_t stream,
                int* launched) {
  const long long BH = (long long)B * H;
  const int M = (T - 1) * B;
  // The saved states of live h_prev (hseq itself at T = 1: no rows).
  const float* hp = hseq + (reverse && M > 0 ? BH : 0);
  if (T < 1 || B < 1 || H < 1 ||
      !fp32_ring::plan_ok<float, true>(wa, wb, stages, smem_gh, hp,
                                       (long long)H * 4, uh,
                                       3LL * H * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const gru_seq_f32::GhChain g{hp, uh, gh};
  const cudaError_t err = gru_seq_f32::gh_launch(g, g, 1, M, H, wa, wb,
                                                 smem_gh, stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const gru_seq_f32::BwdChain c{gx, gh, hseq, uh, bhn, ghT, dpart, gq, dgx,
                                reverse};
  const BwdArgs a{{c, c}, lens, T, B, H};
  const int rc = gru_seq_f32::persist_launch<BwdTile>(
      bwd_kernel(H), gru_seq_f32::bwd_smem(H), a, B, H, 1, 1, stream,
      launched);
  if (rc != 0) return rc;
  return static_cast<int>(
      duh_dbhn(hseq, gq, duh, dbhn, T, B, H, reverse, stream, launched));
}

// The step form: dh [2, B, H] f32 with dh[0] = the cotangent of hT
// (overwritten) in place of ghT and no gh scratch; otherwise gru_bwd_f32's
// arguments. 2T + 1 launches on `stream`, added to *launched.
int gru_bwd_f32_step(const float* gx, const float* hseq, const int* lens,
                     const float* uh, const float* bhn, float* dh,
                     float* dpart, float* gq, float* dgx, float* duh,
                     float* dbhn, int T, int B, int H, int reverse,
                     cudaStream_t stream, int* launched) {
  const long long BH = (long long)B * H, H3 = 3LL * H;
  const dim3 step_grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                       (B + gru_f32::BM - 1) / gru_f32::BM);
  constexpr int DH_TILE = 32;
  const dim3 dh_grid((H + DH_TILE - 1) / DH_TILE, (B + DH_TILE - 1) / DH_TILE);
  cudaError_t err;
  for (int s = 0; s < T; ++s) {
    const int t = reverse ? s : T - 1 - s;
    const bool first = reverse ? t == T - 1 : t == 0;
    const float* hprev =
        first ? nullptr : hseq + (reverse ? t + 1 : t - 1) * BH;
    float* dcur = dh + (s % 2) * BH;
    gru_f32::gru_f32_step_kernel<true><<<step_grid, fp32_tile::THREADS, 0,
                                         stream>>>(
        gx + t * B * H3, hprev, lens, t, uh, bhn, B, H, nullptr, nullptr,
        dcur, dgx + t * B * H3, gq + t * B * H3, dpart);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
    if (s == T - 1) break;  // the chain's start: no dh_prev is read
    fp32_tile::product_kernel<DH_TILE, DH_TILE, 32, true, true>
        <<<dh_grid, fp32_tile::THREADS, 0, stream>>>(
            fp32_tile::Dense{gq + t * B * H3, H3},
            fp32_tile::DenseT{uh, H3}, B, H, int(H3), int(H3), dpart,
            dh + ((s + 1) % 2) * BH, H);
    ++*launched;
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return static_cast<int>(
      duh_dbhn(hseq, gq, duh, dbhn, T, B, H, reverse, stream, launched));
}

}  // extern "C"
