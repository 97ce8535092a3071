// gru_seq_f32.cuh: the persistent kernels of the float32 GRU, for Hopper
// (sm_90a): K1f's recurrence (csrc/gru_fwd_f32.cu, gru_f32_seq_kernel)
// and the chain of K3f's BPTT (csrc/gru_bwd_f32.cu, gru_f32_bptt_kernel),
// each one cooperative launch for all T steps, with one grid barrier a
// step; and K3f's product of every step's gh ahead of the chain
// (gru_f32_gh_kernel, on fp32_ring.cuh's tile loop). K6f and K7f
// (csrc/bigru_{fwd,bwd}_f32.cu) run the same kernels on both chains of a
// bidirectional GRU, the chain on blockIdx.z, and the dU_h of K3f and of
// both chains of K7f on fp32_ring.cuh's loop (gru_f32_duh_kernel). The gh
// and dU_h products also serve the BPTT's step form (gru_bptt_f32.cuh),
// which reads only the live row-steps through its lists. The gate math is
// gru_step_f32.cuh's (gates, cell, cell_bwd), which the step forms of all
// four (taken where these kernels do not fit) run too.
//
// Every product is an FFMA chain with an f32 sum, one chain an output, k
// ascending from zero, as fp32_tile.cuh's loop takes it: the float32 path
// meets a float64 oracle and takes no TF32. Columns past the operands'
// ends are zero-filled, and a zero product leaves a sum that is never -0
// unchanged, so every output equals the step form's bit for bit.
//
// What bounds them on an H100: a step's products, [B, H] x [H, 3H] forward
// and [B, 3H] x [3H, H] for the carried dh, spread over H / 16 x B / 64
// blocks (128 at B = 256, H = 512), 1.57 M FFMA a block a step, 12.3 k
// cycles at an SM's 128 FFMA a cycle (7 us at 1.755 GHz). An SM moves 128
// bytes a cycle from shared memory into registers, and a thread with an
// m x n tile of sums loads m + n floats for m * n FFMA, so the loads cost
// (m + n) / (m n) floats an FFMA against the FFMA pipes' 1/4: the
// forward's 4 x 3 tile 0.58 (at most 43% of the FFMA rate), the chain's
// 4 x 2 tile 0.75 (33%). A larger tile a thread leaves fewer warps than
// hide the loads' latency at 3072 (forward) or 1024 (chain) sums a block:
// PERF.md (PR 28) has the tilings timed. Then the T dependent steps: a
// grid barrier, a refill of the ring and the gate math a step (~3 us
// forward, ~5 us for the chain).
//
// Design, after gru_fwd_step.cuh and gru_bwd_step.cuh (the 16-bit K1 and
// K3):
//  - A block owns UNITS = 16 hidden units (unit tile jx) for the whole
//    call and walks b-tiles of ROWS = 64 rows (FwdPairTile: 128) by, by +
//    gridDim.y, ... in every step. It keeps its slice of U_h in shared
//    memory for the call, loaded once: forward, the 48 columns {u0, H+u0,
//    2H+u0} + 0..15 transposed to [48][H + pad] (96 KB at H = 512); the
//    chain, U_h's rows u0 .. u0+15 as they lie, [16][3H + pad] (96 KB).
//  - The step's other operand, rows of the state that every block wrote
//    before the barrier (forward h_prev = hseq[t -/+ 1], chain g_{t +/- 1}),
//    streams through a ring of cp.async.cg copies (L2 only), KC columns a
//    stage, so the products start on the first stage while the rest
//    arrive. Where H is not a multiple of 4 (rows not 16-byte aligned) the
//    stages are loaded through L2 a float at a time, synchronously.
//  - Thread (ty, tx) = (tid / UG, tid % UG) keeps the sums of rows
//    ty + RG i and units tx + UG e (Tile): forward 256 threads, 4 rows x
//    one unit's 3 gates; chain 128 threads, 4 rows x 2 units of dh. Both
//    operands are read as 128-bit k-quads from rows padded by 4 floats, so
//    a quarter warp (one ty) reads one row of its operand A (a broadcast)
//    and 8 consecutive rows of B, in distinct bank groups.
//  - The elementwise operands (gx, forward h_prev, chain gh, h_prev, dpart
//    or dh_T, the lengths) are loaded into registers ahead of the step's
//    products, whose time hides their latency; the epilogue runs the gate
//    math on the sums in registers.
//  - The chain exchanges only g_t, written to gq [T, B, 3H] (which dU_h
//    and db_hn then read); dpart, the part of dh that skips U_h, is read
//    and written by the thread that owns it. The recompute of gh is off
//    the chain: gru_f32_gh_kernel forms every step's gh in one product
//    before it.
//
// The launch (ops/kernels.py::gru_f32_plan): H / 16 unit tiles (rounded
// up) x as many rows of blocks as there are b-tiles, but no more than are
// resident beside each other (the occupancy query's blocks per SM), x the
// chains a launch (z: 1, or 2 for both chains of K6f/K7f), one block an SM
// at H = 512; persist_grid derives the same grid. Where a row of both
// chains' unit tiles cannot be resident at once but one chain's can, K6f
// and K7f take one launch a chain (z 1). Where a block's slice and ring
// exceed its shared memory (past H = 1024 forward and H = 1013 for the
// chain on an H100) or a row of one chain's unit tiles cannot be resident
// at once, ops/kernels.py::gru_f32_route sends the wrappers to the step
// form. Tail units and tail rows are masked, never returned from: every
// block reaches every grid barrier. No atomics: two calls give the same
// bits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "fp32_ring.cuh"
#include "gru_step_f32.cuh"

namespace gru_seq_f32 {

namespace cgrp = cooperative_groups;

constexpr int UNITS = 16;  // hidden units a block owns
constexpr int ROWS = 64;   // batch rows of a b-tile

// A block's tiling: b-tiles of BR rows (ROWS, or two b-tiles' 128), TR rows
// x TU units of sums a thread (rows ty + RG i, units tx + UG e of the
// block's), KC columns a ring stage, S stages.
template <int TR_, int TU_, int KC_, int S_, int BR_ = ROWS>
struct Tile {
  static constexpr int TR = TR_, TU = TU_, KC = KC_, S = S_, BR = BR_;
  static constexpr int RG = BR / TR;      // row groups
  static constexpr int UG = UNITS / TU;   // unit lanes
  static constexpr int THREADS = RG * UG;
  static constexpr int P = KC + 4;        // floats a ring row
};
// K1f: 256 threads, 12 sums each (4 rows x one unit's 3 gates), 2 stages
// of 64 columns; K3f's chain: 128 threads, 8 sums each (4 rows x 2
// units), 4 stages of 32 columns. PERF.md (PR 28) has the tilings timed
// against them. K6f, where a block would walk two 64-row b-tiles a step
// (ops/kernels.py::gru_f32_plan), takes them as one of 128 rows: 256
// threads of 8 rows x one unit's 3 gates, (8 + 3) / 24 = 0.46 shared
// floats an FFMA against FwdTile's 0.58, the same sums in the same order.
// The chain's 128-row tiling (8 x 2 sums) spilled at 255 registers and
// lost (PERF.md).
using FwdTile = Tile<4, 1, 64, 2>;
using BwdTile = Tile<4, 2, 32, 4>;
using FwdPairTile = Tile<8, 1, 64, 2, 128>;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
// The padded depths of the products: H (forward) and 3H (chain) rounded up
// to a stage's columns.
template <class Tl>
__host__ __device__ constexpr int fwd_depth(int H) {
  return round_up(H, Tl::KC);
}
template <class Tl>
__host__ __device__ constexpr int bwd_depth(int H) {
  return round_up(3 * H, Tl::KC);
}
template <class Tl>
__host__ __device__ constexpr size_t ring_bytes() {
  return static_cast<size_t>(Tl::S) * Tl::BR * Tl::P * 4;
}
// Us [48][fwd_depth + 4] | ring [S][BR][KC + 4], all f32.
template <class Tl = FwdTile>
__host__ __device__ constexpr size_t fwd_smem(int H) {
  return static_cast<size_t>(3 * UNITS) * (fwd_depth<Tl>(H) + 4) * 4 +
         ring_bytes<Tl>();
}
// Ur [16][bwd_depth + 4] | ring [S][BR][KC + 4], all f32.
template <class Tl = BwdTile>
__host__ __device__ constexpr size_t bwd_smem(int H) {
  return static_cast<size_t>(UNITS) * (bwd_depth<Tl>(H) + 4) * 4 +
         ring_bytes<Tl>();
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Columns kc .. kc + KC - 1 of rows b0 .. b0 + BR - 1 of X [B, ld] f32 into a
// ring stage [BR][KC + 4], zero at b >= B or k >= K. V16: 16-byte
// cp.async.cg copies (L2 only: other blocks wrote X before the last grid
// barrier), in the thread's current commit group. Else floats loaded
// through L2 (ld.global.cg) and stored synchronously.
template <class Tl, bool V16>
__device__ __forceinline__ void stage(float* st, const float* X, long long ld,
                                      int b0, int B, int kc, int K) {
  constexpr int Q = Tl::KC / 4;
  static_assert(Tl::BR * Q % Tl::THREADS == 0, "whole copies a thread");
#pragma unroll
  for (int i0 = 0; i0 < Tl::BR * Q; i0 += Tl::THREADS) {
    const int i = i0 + threadIdx.x;
    const int r = i / Q, q = (i % Q) * 4;
    const int b = b0 + r, k = kc + q;
    float* dst = st + r * Tl::P + q;
    const float* src = X + static_cast<long long>(b) * ld + k;
    if constexpr (V16) {
      const bool ok = b < B && k < K;
      fp32_ring::cp_async<16>(dst, ok ? src : X, ok);
    } else {
      float4 v;
      v.x = b < B && k < K ? __ldcg(src) : 0.f;
      v.y = b < B && k + 1 < K ? __ldcg(src + 1) : 0.f;
      v.z = b < B && k + 2 < K ? __ldcg(src + 2) : 0.f;
      v.w = b < B && k + 3 < K ? __ldcg(src + 3) : 0.f;
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
}

// k-quad q of a stage: the thread's A rows (ty + RG i, from As) and B rows
// (b_rows[n] * ldb floats from Bs) as 128-bit loads.
template <class Tl, int NB>
__device__ __forceinline__ void quad_load(const float* As, const float* Bs,
                                          int ldb, const int (&b_rows)[NB],
                                          int q, float4 (&a)[Tl::TR],
                                          float4 (&w)[NB]) {
#pragma unroll
  for (int i = 0; i < Tl::TR; ++i)
    a[i] = *reinterpret_cast<const float4*>(As + Tl::RG * i * Tl::P + 4 * q);
#pragma unroll
  for (int n = 0; n < NB; ++n)
    w[n] = *reinterpret_cast<const float4*>(Bs + b_rows[n] * ldb + 4 * q);
}

// The quad's FFMA: each sum takes its four k in ascending order.
template <class Tl, int NB>
__device__ __forceinline__ void quad_fma(const float4 (&a)[Tl::TR],
                                         const float4 (&w)[NB],
                                         float (&acc)[Tl::TR][NB]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < Tl::TR; ++i)
#pragma unroll
      for (int n = 0; n < NB; ++n)
        acc[i][n] = fmaf(lane(a[i], kk), lane(w[n], kk), acc[i][n]);
}

// One ring stage's products: acc[i][n] += sum over the stage's KC columns
// of A's row (ty + RG i) times B's row b_rows[n], one FFMA chain a sum, k
// ascending.
template <class Tl, int NB>
__device__ __forceinline__ void stage_products(const float* As,
                                               const float* Bs, int ldb,
                                               const int (&b_rows)[NB],
                                               float (&acc)[Tl::TR][NB]) {
  float4 a[Tl::TR], w[NB];
#pragma unroll
  for (int q = 0; q < Tl::KC / 4; ++q) {
    quad_load<Tl, NB>(As, Bs, ldb, b_rows, q, a, w);
    quad_fma<Tl, NB>(a, w, acc);
  }
}

// One chain's operands of the recurrence.
struct FwdChain {
  const float* gx;   // [T, B, 3H]
  const float* uh;   // [H, 3H]
  const float* bhn;  // [H]
  float* hseq;       // [T, B, H]
  float* hT;         // [B, H]
  int reverse;
};

// The recurrence of one chain (K1f: grid z 1, c[0]) or of both chains of
// a bidirectional GRU (K6f: block (jx, by, z) takes chain c[z]), under
// one set of lengths.
struct FwdArgs {
  FwdChain c[2];
  const int* lens;  // [B]
  int T, B, H;
};

template <class Tl, bool V16>
__global__ void __launch_bounds__(Tl::THREADS, 1)
    gru_f32_seq_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float seq_smem[];
  constexpr int TR = Tl::TR, TU = Tl::TU, RG = Tl::RG, UG = Tl::UG;
  constexpr int KC = Tl::KC, S = Tl::S, NB = 3 * TU;
  const FwdChain p = blockIdx.z == 0 ? a.c[0] : a.c[1];
  const int T = a.T, B = a.B, H = a.H;
  const int HK = fwd_depth<Tl>(H), UP = HK + 4;
  const long long H3 = 3LL * H, BH = static_cast<long long>(B) * H;
  float* Us = seq_smem;  // Us[g * 16 + uu][k] = U_h[k, g * H + u0 + uu]
  float* ring = seq_smem + 3 * UNITS * UP;
  const int tid = threadIdx.x, ty = tid / UG, tx = tid % UG;
  const int u0 = blockIdx.x * UNITS;

  // U_h's 48 columns, transposed once, zero past H (units and k).
  for (int i = tid; i < 3 * UNITS * HK; i += Tl::THREADS) {
    const int k = i / (3 * UNITS), v = i % (3 * UNITS);
    const int g = v / UNITS, u = u0 + v % UNITS;
    Us[v * UP + k] =
        k < H && u < H ? __ldg(p.uh + k * H3 + g * H + u) : 0.f;
  }
  __syncthreads();

  // The thread's B rows: gate g of unit tx + UG e at n = g TU + e.
  int b_rows[NB];
  float bh[TU];
#pragma unroll
  for (int e = 0; e < TU; ++e) {
    const int u = u0 + tx + UG * e;
    bh[e] = u < H ? __ldg(p.bhn + u) : 0.f;
#pragma unroll
    for (int g = 0; g < 3; ++g) b_rows[g * TU + e] = g * UNITS + tx + UG * e;
  }
  const int ntiles = (B + Tl::BR - 1) / Tl::BR;
  const int nchunk = HK / KC;
  cgrp::grid_group grid = cgrp::this_grid();
  for (int k = 0; k < T; ++k) {
    const int t = p.reverse ? T - 1 - k : k;
    // null at the chain's first step: the zero state, no product.
    const float* hprev =
        k == 0 ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * BH;
    const float* gxt = p.gx + t * 3 * BH;
    float* ho = p.hseq + t * BH;
    float* hTo = k == T - 1 ? p.hT : nullptr;
    for (int bt = blockIdx.y; bt < ntiles; bt += gridDim.y) {
      const int b0 = bt * Tl::BR;
      if (hprev != nullptr) {
#pragma unroll
        for (int s = 0; s < S - 1; ++s) {
          if (s < nchunk)
            stage<Tl, V16>(ring + s * Tl::BR * Tl::P, hprev, H, b0, B, s * KC,
                           H);
          fp32_ring::cp_async_commit();
        }
      }
      // The epilogue's operands, loaded ahead of the products.
      float x[TR][TU][3], hp[TR][TU];
      bool live[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int b = b0 + ty + RG * i;
        live[i] = b < B && t < __ldg(a.lens + b);
#pragma unroll
        for (int e = 0; e < TU; ++e) {
          const int u = u0 + tx + UG * e;
          const bool ok = b < B && u < H;
#pragma unroll
          for (int g = 0; g < 3; ++g)
            x[i][e][g] = ok ? __ldg(gxt + b * H3 + g * H + u) : 0.f;
          hp[i][e] = ok && hprev != nullptr
                         ? __ldcg(hprev + static_cast<long long>(b) * H + u)
                         : 0.f;
        }
      }
      float acc[TR][NB];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int n = 0; n < NB; ++n) acc[i][n] = 0.f;
      if (hprev != nullptr) {
        for (int c = 0; c < nchunk; ++c) {
          fp32_ring::cp_async_wait<S - 2>();
          __syncthreads();
          const int nx = c + S - 1;
          if (nx < nchunk)
            stage<Tl, V16>(ring + (nx % S) * Tl::BR * Tl::P, hprev, H, b0, B,
                           nx * KC, H);
          fp32_ring::cp_async_commit();
          stage_products<Tl, NB>(
              ring + (c % S) * Tl::BR * Tl::P + ty * Tl::P, Us + c * KC, UP,
              b_rows, acc);
        }
        fp32_ring::cp_async_wait<0>();
        __syncthreads();  // the ring is free for the next b-tile
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int b = b0 + ty + RG * i;
#pragma unroll
        for (int e = 0; e < TU; ++e) {
          const int u = u0 + tx + UG * e;
          if (b >= B || u >= H) continue;
          const gru_f32::Gates q = gru_f32::gates(
              x[i][e][0], x[i][e][1], x[i][e][2], acc[i][e], acc[i][TU + e],
              acc[i][2 * TU + e], bh[e]);
          const float h = gru_f32::cell(q, hp[i][e], live[i]);
          const long long o = static_cast<long long>(b) * H + u;
          ho[o] = h;
          if (hTo != nullptr) hTo[o] = h;
        }
      }
    }
    if (k + 1 < T) grid.sync();
  }
}

// One chain's operands of the BPTT.
struct BwdChain {
  const float* gx;    // [T, B, 3H]
  const float* gh;    // [T - 1, B, 3H]: gh of each step but the first
  const float* hseq;  // [T, B, H], K1f's
  const float* uh;    // [H, 3H]
  const float* bhn;   // [H]
  const float* ghT;   // [B, H]: the cotangent of the final state
  float* dpart;       // [B, H] scratch
  float* gq;          // [T, B, 3H]: g_t
  float* dgx;         // [T, B, 3H]
  int reverse;
};

// The BPTT chain of one direction (K3f: grid z 1, c[0]) or of both (K7f:
// block (jx, by, z) takes chain c[z]), under one set of lengths.
struct BwdArgs {
  BwdChain c[2];
  const int* lens;  // [B]
  int T, B, H;
};

template <class Tl, bool V16>
__global__ void __launch_bounds__(Tl::THREADS, 1)
    gru_f32_bptt_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float seq_smem[];
  constexpr int TR = Tl::TR, TU = Tl::TU, RG = Tl::RG, UG = Tl::UG;
  constexpr int KC = Tl::KC, S = Tl::S;
  const BwdChain p = blockIdx.z == 0 ? a.c[0] : a.c[1];
  const int T = a.T, B = a.B, H = a.H;
  const int K3 = 3 * H, KD = bwd_depth<Tl>(H), UP = KD + 4;
  const long long H3 = 3LL * H, BH = static_cast<long long>(B) * H,
                  BH3 = 3 * BH;
  float* Ur = seq_smem;  // Ur[jj][c] = U_h[u0 + jj, c]
  float* ring = seq_smem + UNITS * UP;
  const int tid = threadIdx.x, ty = tid / UG, tx = tid % UG;
  const int u0 = blockIdx.x * UNITS;

  // U_h's rows u0 .. u0 + 15 once, zero past 3H and past H.
  for (int i = tid; i < UNITS * KD; i += Tl::THREADS) {
    const int jj = i / KD, c = i % KD;
    Ur[jj * UP + c] =
        c < K3 && u0 + jj < H ? __ldg(p.uh + (u0 + jj) * H3 + c) : 0.f;
  }
  __syncthreads();

  int b_rows[TU];  // the thread's B rows: units tx + UG e
  float bh[TU];
#pragma unroll
  for (int e = 0; e < TU; ++e) {
    const int u = u0 + tx + UG * e;
    bh[e] = u < H ? __ldg(p.bhn + u) : 0.f;
    b_rows[e] = tx + UG * e;
  }
  const int ntiles = (B + Tl::BR - 1) / Tl::BR;
  const int nchunk = KD / KC;
  cgrp::grid_group grid = cgrp::this_grid();
  for (int k = 0; k < T; ++k) {
    const int t = p.reverse ? k : T - 1 - k;
    const bool first = p.reverse ? t == T - 1 : t == 0;  // zero h_prev
    // g of the step before in the walk: null at the walk's first step,
    // whose dh is ghT.
    const float* gprev =
        k == 0 ? nullptr : p.gq + (p.reverse ? t - 1 : t + 1) * BH3;
    const float* hprev =
        first ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * BH;
    const float* ght =
        first ? nullptr : p.gh + (p.reverse ? t : t - 1) * BH3;
    const float* gxt = p.gx + t * BH3;
    float* dgxt = p.dgx + t * BH3;
    float* gqt = p.gq + t * BH3;
    for (int bt = blockIdx.y; bt < ntiles; bt += gridDim.y) {
      const int b0 = bt * Tl::BR;
      if (gprev != nullptr) {
#pragma unroll
        for (int s = 0; s < S - 1; ++s) {
          if (s < nchunk)
            stage<Tl, V16>(ring + s * Tl::BR * Tl::P, gprev, H3, b0, B, s * KC,
                           K3);
          fp32_ring::cp_async_commit();
        }
      }
      // The epilogue's operands, loaded ahead of the products.
      float x[TR][TU][3], q3[TR][TU][3], hp[TR][TU], d0[TR][TU];
      bool live[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int b = b0 + ty + RG * i;
        live[i] = b < B && t < __ldg(a.lens + b);
#pragma unroll
        for (int e = 0; e < TU; ++e) {
          const int u = u0 + tx + UG * e;
          const bool ok = b < B && u < H;
          const long long o = static_cast<long long>(b) * H + u;
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            x[i][e][g] = ok ? __ldg(gxt + b * H3 + g * H + u) : 0.f;
            q3[i][e][g] =
                ok && ght != nullptr ? __ldg(ght + b * H3 + g * H + u) : 0.f;
          }
          hp[i][e] = ok && hprev != nullptr ? __ldg(hprev + o) : 0.f;
          d0[i][e] = !ok ? 0.f
                     : gprev == nullptr ? __ldg(p.ghT + o)
                                        : __ldcg(p.dpart + o);
        }
      }
      float acc[TR][TU];
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int e = 0; e < TU; ++e) acc[i][e] = 0.f;
      if (gprev != nullptr) {
        for (int c = 0; c < nchunk; ++c) {
          fp32_ring::cp_async_wait<S - 2>();
          __syncthreads();
          const int nx = c + S - 1;
          if (nx < nchunk)
            stage<Tl, V16>(ring + (nx % S) * Tl::BR * Tl::P, gprev, H3, b0, B,
                           nx * KC, K3);
          fp32_ring::cp_async_commit();
          stage_products<Tl, TU>(
              ring + (c % S) * Tl::BR * Tl::P + ty * Tl::P, Ur + c * KC, UP,
              b_rows, acc);
        }
        fp32_ring::cp_async_wait<0>();
        __syncthreads();  // the ring is free for the next b-tile
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int b = b0 + ty + RG * i;
#pragma unroll
        for (int e = 0; e < TU; ++e) {
          const int u = u0 + tx + UG * e;
          if (b >= B || u >= H) continue;
          // dh = dpart + g_prev U_h^T, rounded as the step form's product
          // adds its `add`; the walk's first step carries ghT as it is.
          const float d =
              gprev != nullptr ? __fadd_rn(d0[i][e], acc[i][e]) : d0[i][e];
          const gru_f32::Gates q = gru_f32::gates(
              x[i][e][0], x[i][e][1], x[i][e][2], q3[i][e][0], q3[i][e][1],
              q3[i][e][2], bh[e]);
          const gru_f32::Cotangents cot =
              gru_f32::cell_bwd(q, hp[i][e], d, live[i]);
          const long long o = static_cast<long long>(b) * H + u;
          float* dg = dgxt + b * H3;
          dg[u] = cot.da_r;
          dg[H + u] = cot.da_z;
          dg[2 * H + u] = cot.da_n;
          float* gqb = gqt + b * H3;
          gqb[u] = cot.da_r;
          gqb[H + u] = cot.da_z;
          gqb[2 * H + u] = cot.dgh_n;
          __stcg(p.dpart + o, cot.dpart);
        }
      }
    }
    if (k + 1 < T) grid.sync();
  }
}
// Rows of the saved states: row i is base + list[i] * ld, or base + i * ld
// where list is null (every row-step, the persistent form's). The step
// form's list holds the live row-steps (csrc/gru_bptt_f32.cuh).
struct StepRows {
  using elem = float;
  const float* rows;
  const int* list;
  int ld;
  __device__ __forceinline__ const float* cell(int i) const {
    return rows +
           static_cast<long long>(list != nullptr ? __ldg(list + i) : i) * ld;
  }
  __host__ __device__ const float* base() const { return rows; }
};

// One chain's gh product: gh = hp @ U_h [H, 3H] over the rows of live
// h_prev, hp [(T - 1) B, H] (hseq shifted by a step): all of them where
// list is null, else the *count rows list[i], each written to its own row
// of gh.
struct GhChain {
  const float* hp;   // [(T - 1) B, H]
  const float* uh;   // [H, 3H]
  float* gh;         // [(T - 1) B, 3H]
  const int* list;   // null, or [*count] row indices of hp
  const int* count;  // null, or the rows of the list
};

// gh of one chain (K3f: grid z 1) or of both (K7f: blockIdx.z picks c0 or
// c1) on fp32_ring.cuh's loop: 128 x 128 tiles, A K-major (a state's
// units are k), each sum an FFMA chain over k = 0 .. H - 1 as the step
// form's. A grid of at least one row of tiles for M rows: at M = 0 (T =
// 1) it writes nothing, and a block past a list's count returns at once.
template <int WA, int WB>
__global__ void __launch_bounds__(fp32_ring::THREADS, 2)
    gru_f32_gh_kernel(GhChain c0, GhChain c1, int M, int H, int wa, int wb) {
  extern __shared__ __align__(16) unsigned char smem_gh[];
  const GhChain c = blockIdx.z == 0 ? c0 : c1;
  const int rows = c.count != nullptr ? __ldg(c.count) : M;
  float acc[8][8] = {};
  const int m0 = blockIdx.y * fp32_ring::TILE;
  const int n0 = blockIdx.x * fp32_ring::TILE;
  if (m0 >= rows) return;  // the whole block: past the rows
  const long long N = 3LL * H;
  fp32_ring::mainloop<float, true, WA, WB>(StepRows{c.hp, c.list, H}, c.uh,
                                           N, rows, 3 * H, m0, n0, 0, H, wa,
                                           wb, acc, smem_gh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= rows) continue;
    float* out = c.gh + (c.list != nullptr ? __ldg(c.list + m) : m) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (n < N) out[n] = acc[i][j];
    }
  }
}

// The gh launch of `chains` chains (1: c0; 2: c0 and c1 on blockIdx.z) over
// at most M rows each, on a ring plan that fp32_ring::plan_ok<float, true>
// has passed for each chain's hp and U_h; adds one to *launched.
inline cudaError_t gh_launch(GhChain c0, GhChain c1, int chains, int M,
                             int H, int wa, int wb, int smem,
                             cudaStream_t stream, int* launched) {
  return fp32_ring::by_plan(wa, wb, [&](auto fa, auto fb) {
    auto* kernel =
        gru_f32_gh_kernel<decltype(fa)::value, decltype(fb)::value>;
    cudaError_t e = fp32_ring::opt_in(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tile = fp32_ring::TILE;
    const dim3 grid((3 * H + tile - 1) / tile,
                    std::max(1, (M + tile - 1) / tile), chains);
    kernel<<<grid, fp32_ring::THREADS, smem, stream>>>(c0, c1, M, H, wa, wb);
    ++*launched;
    return cudaGetLastError();
  });
}

// One chain's dU_h: duh [H, 3H] = hp^T g over the rows of live h_prev, hp
// [K, H] and g [K, 3H] (gq shifted by a step): all K = (T - 1) B where
// list is null, else the *count row-steps list[i] of both, in the list's
// (ascending) order.
struct DuhChain {
  const float* hp;   // [(T - 1) B, H]
  const float* g;    // [(T - 1) B, 3H]
  float* duh;        // [H, 3H]
  const int* list;   // null, or [*count] row indices of hp and g
  const int* count;  // null, or the rows of the list
};

// dU_h of K3f (grid z 1) or of both chains of K7f (blockIdx.z picks c0 or
// c1) on fp32_ring.cuh's loop: 128 x 128 tiles of [H, 3H], A MN-major (the
// rows of hp are k), B's rows through the same index (IndexedB), each sum
// one FFMA chain over the rows in order from zero, as fp32_tile.cuh's
// product took it over all (T - 1) B rows: a row-step the list leaves out
// is one whose g row is +-0 or whose h_prev row is 0, which adds nothing to
// a sum that is never -0, so every form's dU_h is the same bits. With no
// rows (T = 1) it writes zeros.
template <int WA, int WB>
__global__ void __launch_bounds__(fp32_ring::THREADS, 2)
    gru_f32_duh_kernel(DuhChain c0, DuhChain c1, int K, int H, int wa,
                       int wb) {
  extern __shared__ __align__(16) unsigned char smem_duh[];
  const DuhChain c = blockIdx.z == 0 ? c0 : c1;
  const int rows = c.count != nullptr ? __ldg(c.count) : K;
  float acc[8][8] = {};
  const int m0 = blockIdx.y * fp32_ring::TILE;
  const int n0 = blockIdx.x * fp32_ring::TILE;
  const long long N = 3LL * H;
  fp32_ring::mainloop<float, false, WA, WB>(
      StepRows{c.hp, c.list, H}, fp32_ring::IndexedB{c.g, c.list, N}, H,
      3 * H, m0, n0, 0, rows, wa, wb, acc, smem_duh);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 8 + j;
      if (m < H && n < N) c.duh[m * N + n] = acc[i][j];
    }
  }
}

// The dU_h launch of `chains` chains over at most K rows each, on a ring
// plan that fp32_ring::plan_ok<float, false, true> has passed for each
// chain's hp and g; adds one to *launched.
inline cudaError_t duh_launch(DuhChain c0, DuhChain c1, int chains, int K,
                              int H, int wa, int wb, int smem,
                              cudaStream_t stream, int* launched) {
  return fp32_ring::by_plan(wa, wb, [&](auto fa, auto fb) {
    auto* kernel =
        gru_f32_duh_kernel<decltype(fa)::value, decltype(fb)::value>;
    cudaError_t e = fp32_ring::opt_in(kernel, smem);
    if (e != cudaSuccess) return e;
    const int tile = fp32_ring::TILE;
    const dim3 grid((3 * H + tile - 1) / tile, (H + tile - 1) / tile,
                    chains);
    kernel<<<grid, fp32_ring::THREADS, smem, stream>>>(c0, c1, K, H, wa, wb);
    ++*launched;
    return cudaGetLastError();
  });
}

// The persistent kernel's blocks resident per SM at its dynamic shared
// memory `smem` (0 where that exceeds a block's), granting it that memory,
// and its grid at batch B and width H for `chains` chains (1 or 2):
// ceil(H / 16) unit tiles x min(ceil(B / 64), resident rows) x z, z =
// chains where a row of every chain's unit tiles is resident at once,
// else 1 (one launch a chain) where one chain's is; 0 x 0 x 0 where not
// even that. ops/kernels.py::gru_f32_plan computes the same grid from the
// same blocks per SM.
template <class Tl, class Kernel>
cudaError_t persist_grid(Kernel* kernel, size_t smem, int B, int H,
                         int chains, dim3* grid, int* per_sm) {
  *grid = dim3(0, 0, 0);
  *per_sm = 0;
  int dev = 0, optin = 0, sms = 0, coop = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  if (B < 1 || H < 1 || chains < 1 || chains > 2)
    return cudaErrorInvalidValue;
  if (smem > static_cast<size_t>(optin)) return cudaSuccess;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem))) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, kernel, Tl::THREADS, smem)) != cudaSuccess)
    return e;
  const int jt = (H + UNITS - 1) / UNITS;
  for (int z = chains; z >= 1; --z) {
    const int rows = *per_sm * sms / (z * jt);
    if (rows >= 1) {
      *grid = dim3(jt, std::min((B + Tl::BR - 1) / Tl::BR, rows), z);
      break;
    }
  }
  return cudaSuccess;
}

// The persistent kernel's launch at (B, H) for `chains` chains, for the C
// entries' *_config: grid[3] (0 x 0 x 0 where it cannot be resident),
// blocks per SM and dynamic shared memory. Returns the queries' CUDA
// error, clearing it from the runtime.
template <class Tl, class Kernel>
int persist_config(Kernel* kernel, size_t smem, int B, int H, int chains,
                   int* grid, int* per_sm, long long* smem_bytes) {
  dim3 g;
  const cudaError_t e =
      persist_grid<Tl>(kernel, smem, B, H, chains, &g, per_sm);
  if (e != cudaSuccess) cudaGetLastError();
  grid[0] = static_cast<int>(g.x);
  grid[1] = static_cast<int>(g.y);
  grid[2] = static_cast<int>(g.z);
  *smem_bytes = static_cast<long long>(smem);
  return static_cast<int>(e);
}

// The cooperative launches of `kernel` for `chains` chains (a.c[0], and
// a.c[1] where chains is 2), at most `z` of them a launch (1 <= z <=
// chains), on its grid (persist_grid for z chains): one launch where the
// grid takes every chain, else one a chain, each with the chain in c[0]
// and c[1] (grid z 1). Each launch is counted in *launched; returns the
// CUDA error, among them cudaErrorCooperativeLaunchTooLarge where the
// grid cannot be resident, clearing it from the runtime.
template <class Tl, class Kernel, class Args>
int persist_launch(Kernel* kernel, size_t smem, Args a, int B, int H,
                   int chains, int z, cudaStream_t stream, int* launched) {
  dim3 grid;
  int per_sm = 0;
  cudaError_t e = z < 1 || z > chains
                      ? cudaErrorInvalidValue
                      : persist_grid<Tl>(kernel, smem, B, H, z, &grid,
                                         &per_sm);
  if (e == cudaSuccess && grid.y == 0) e = cudaErrorCooperativeLaunchTooLarge;
  const int launches = e == cudaSuccess ? chains / static_cast<int>(grid.z)
                                        : 0;
  for (int i = 0; e == cudaSuccess && i < launches; ++i) {
    Args one = a;
    if (launches > 1) one.c[0] = one.c[1] = a.c[i];
    void* args[] = {&one};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    grid, dim3(Tl::THREADS), args, smem,
                                    stream);
    if (e == cudaSuccess) ++*launched;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace gru_seq_f32
