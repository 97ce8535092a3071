// K6f `bigru_fwd_f32`: both recurrences of a bidirectional GRU in float32,
// advanced together, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_fwd_kernel (the
// Pallas body launched by _bigru_pallas_fwd_call) when the model computes
// in float32 (model.dtype float32): the TPU kernel takes U_h in the model's
// dtype, and K6 (bigru_fwd.cu) takes only bf16. The same function as K6's
// plain version bigru_reference on float32 U_h: step s advances the forward
// chain at t = s and the backward chain at t = T-1-s, both under the prefix
// mask t < lens[b], so the backward chain carries the zero state through
// each row's padded tail first.
//
// What bounds it on an H100 SXM (peak rates at its 700 W limit): at
// B=256, H=512, T=26 the hidden products after each row's first step are
// at most 2 x 25 x 2 x 256 x 512 x 1536 = 20.1 GFLOP of f32 FFMA for both
// chains (0.30 ms at 67 TFLOP/s; the bound counts the carried row-steps
// of this run's lengths), against 82 MB of gx, hseq and U_h reads and
// writes: the FP32 pipes, the shared-memory loads that feed them, and the
// T dependent steps. PERF.md has its time beside two K1f calls on an H100
// 80GB HBM3 at 700 W.
//
// Design: K1f's persistent kernel (gru_seq_f32.cuh, gru_f32_seq_kernel)
// with the direction on blockIdx.z, one cooperative launch for all T steps
// of both chains: block (jx, by, d) owns chain d's 16 units for the call,
// its 48 U_h columns resident in shared memory, h_prev streamed through
// the same 2-stage cp.async ring, walking b-tiles by, by + gridDim.y, ...
// in every step; one grid barrier a step serves both chains. At B=256,
// H=512 on an H100 one block fits an SM, so the grid is 32 unit tiles x 2
// rows x 2 chains, and a block that would take 2 of the 4 64-row b-tiles
// a step takes them as one of 128 rows (FwdPairTile, ~165 KB of shared
// memory: 8 rows x one unit's 3 gates a thread, fewer shared loads an
// FFMA); ops/kernels.py::gru_f32_plan chooses the rows, which the wrapper
// passes in. Where a row of both chains' unit tiles cannot be resident at
// once but one chain's can, one launch a chain (grid z 1); where neither
// fits (past ~1024 units, or the block's shared memory), the wrapper
// (ops/kernels.py::gru_f32_route) takes the step form,
// bigru_fwd_f32_step: one launch a step of K1f's step (gru_step_f32.cuh)
// with both chains on blockIdx.z, T launches a call. Each chain runs K1f's
// sums in K1f's order on its inputs, so each direction equals a K1f call
// bit for bit, and every form and tiling gives the same bits.

#include <cuda_runtime.h>

#include "gru_seq_f32.cuh"

namespace {

using gru_seq_f32::FwdArgs;
using gru_seq_f32::FwdChain;
using gru_seq_f32::FwdPairTile;
using gru_seq_f32::FwdTile;
using FwdKernel = void (*)(FwdArgs);

// The persistent instance of tiling Tl at width H: 16-byte copies of
// h_prev where its rows are 16-byte aligned.
template <class Tl>
FwdKernel fwd_kernel(int H) {
  return H % 4 == 0 ? gru_seq_f32::gru_f32_seq_kernel<Tl, true>
                    : gru_seq_f32::gru_f32_seq_kernel<Tl, false>;
}

// f(Tl{}) for the tiling whose b-tiles hold `rows` rows: 64 (K1f's
// FwdTile) or 128 (FwdPairTile, two b-tiles as one); another is refused.
template <class F>
int by_rows(int rows, F&& f) {
  if (rows == FwdTile::BR) return f(FwdTile{});
  if (rows == FwdPairTile::BR) return f(FwdPairTile{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// Step s of both chains: blockIdx.z 0 the forward chain at t = s, 1 the
// backward chain at t = T-1-s.
__global__ void __launch_bounds__(fp32_tile::THREADS)
    bigru_f32_step_kernel(FwdChain fwd, FwdChain bwd,
                          const int* __restrict__ lens, int s, int T, int B,
                          int H) {
  __shared__ fp32_tile::Smem<gru_f32::BM, gru_f32::BN, gru_f32::BK> sm;
  const bool rev = blockIdx.z == 1;
  const FwdChain c = rev ? bwd : fwd;
  const int t = rev ? T - 1 - s : s;
  const long long BH = (long long)B * H;
  const float* hprev =
      s == 0 ? nullptr : c.hseq + (rev ? t + 1 : t - 1) * BH;
  gru_f32::step(c.gx + t * 3 * BH, hprev, lens, t, c.uh, c.bhn, B, H,
                c.hseq + t * BH, s == T - 1 ? c.hT : nullptr, sm);
}

// Both chains' operands: hseq [2, T, B, H] and hT [2, B, H], the forward
// chain first.
FwdArgs chains(const float* gxf, const float* gxb, const int* lens,
               const float* uhf, const float* uhb, const float* bhnf,
               const float* bhnb, float* hseq, float* hT, int T, int B,
               int H) {
  const long long BH = (long long)B * H;
  return FwdArgs{{FwdChain{gxf, uhf, bhnf, hseq, hT, 0},
                  FwdChain{gxb, uhb, bhnb, hseq + T * BH, hT + BH, 1}},
                 lens, T, B, H};
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The persistent launch of both chains at batch B and width H on the
// current device in the tiling of `rows`-row b-tiles (64 or 128): its
// grid[3] (ceil(H / 16) unit tiles x rows of blocks x 2 chains, or x 1
// where only one chain's row of unit tiles is resident at once: one launch
// a chain; 0 x 0 x 0 where not even that, or its shared memory exceeds a
// block's), the blocks resident per SM and the dynamic shared memory.
// Returns the CUDA error of the queries.
int bigru_fwd_f32_config(int B, int H, int rows, int* grid, int* per_sm,
                         long long* smem_bytes) {
  return by_rows(rows, [&](auto tile) {
    using Tl = decltype(tile);
    return gru_seq_f32::persist_config<Tl>(
        fwd_kernel<Tl>(H), gru_seq_f32::fwd_smem<Tl>(H), B, H, 2, grid,
        per_sm, smem_bytes);
  });
}

// gxf, gxb [T, B, 3H] f32, lens [B] i32, uhf, uhb [H, 3H] f32, bhnf, bhnb
// [H] f32 -> hseq [2, T, B, H] f32 and hT [2, B, H] f32 (the forward chain
// first). The cooperative launches of both chains in the tiling of
// `rows`-row b-tiles (ops/kernels.py::gru_f32_plan's: 128 where a block
// would walk two 64-row b-tiles a step), at most z (1 or 2) chains a
// launch: one launch where bigru_fwd_f32_config's grid takes both (z = 2
// and its grid 2 deep), else one a chain; on `stream`, each counted in
// *launched. Returns the CUDA error, among them
// cudaErrorCooperativeLaunchTooLarge where not even one chain's grid can
// be resident (ops/kernels.py::gru_f32_route sends such shapes to
// bigru_fwd_f32_step).
int bigru_fwd_f32(const float* gxf, const float* gxb, const int* lens,
                  const float* uhf, const float* uhb, const float* bhnf,
                  const float* bhnb, float* hseq, float* hT, int T, int B,
                  int H, int rows, int z, cudaStream_t stream,
                  int* launched) {
  if (T < 1) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a =
      chains(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, hseq, hT, T, B, H);
  return by_rows(rows, [&](auto tile) {
    using Tl = decltype(tile);
    return gru_seq_f32::persist_launch<Tl>(
        fwd_kernel<Tl>(H), gru_seq_f32::fwd_smem<Tl>(H), a, B, H, 2, z,
        stream, launched);
  });
}

// The step form on bigru_fwd_f32's arguments but rows and z: one launch a step
// advances both chains, on `stream`; the number launched is added to
// *launched.
int bigru_fwd_f32_step(const float* gxf, const float* gxb, const int* lens,
                       const float* uhf, const float* uhb, const float* bhnf,
                       const float* bhnb, float* hseq, float* hT, int T,
                       int B, int H, cudaStream_t stream, int* launched) {
  const dim3 grid((H + gru_f32::UNITS - 1) / gru_f32::UNITS,
                  (B + gru_f32::BM - 1) / gru_f32::BM, 2);
  const FwdArgs a =
      chains(gxf, gxb, lens, uhf, uhb, bhnf, bhnb, hseq, hT, T, B, H);
  for (int s = 0; s < T; ++s) {
    bigru_f32_step_kernel<<<grid, fp32_tile::THREADS, 0, stream>>>(
        a.c[0], a.c[1], lens, s, T, B, H);
    ++*launched;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
