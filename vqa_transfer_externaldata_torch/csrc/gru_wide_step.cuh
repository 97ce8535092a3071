// The step form of the 16-bit GRU recurrence and its BPTT for Hopper
// (sm_90a), for widths whose persistent kernels cannot run: the forward of
// K1/K6 past the U_h slice a block of gru_fwd_step.cuh can hold (H above
// 1568 on an H100) or where its grid cannot be resident, the BPTT of K3/K7
// past the slices and ring of gru_bwd_step.cuh (H above 576). The libraries
// csrc/gru_fwd_wide.cu and csrc/gru_bwd_wide.cu build it (one direction for
// K1/K3, both on blockIdx.z for K6/K7), and their float16 twins
// (*_wide_f16.cu) build it again with E = float16 (elem16.cuh).
//
// Replaces, at those widths, vqa_transfer_externaldata_tpu/ops/gru.py's
// _gru_fwd_kernel / _bigru_fwd_kernel (B1/B7) and _gru_bwd_kernel /
// _bigru_bwd_kernel (B2/B8), which pad only the batch and take any H. The
// math is that file's _gru_cell and _gru_cell_bwd, as gru_fwd_step.cuh and
// gru_bwd_step.cuh state it; the rounding points are JAX's: h_prev is
// rounded to E ahead of U_h (and of dU_h), the gate cotangents ahead of
// U_h^T and dU_h. Every elementwise product and sum is rounded on its own
// (__fmul_rn / __fadd_rn), as the plain version rounds them, so no
// contraction into an FMA is taken that JAX does not take.
//
// What bounds it on an H100: every step reads U_h (3 H^2 E values: 34.6 MB
// at H = 2400, within the 50 MB L2) once per 64-row b-tile of the batch,
// and the step's 2 B H 3H operations are small (B = 256, H = 2400: 8.8
// GFLOP, 9 us at the 16-bit peak). U_h is not held in shared memory (a
// 16-unit slice is 230 KB at H = 2400): each block streams its slices
// through a cp.async ring, so the L2's rate and the T dependent launches
// bound it.
//
// Design, one launch a step (the launch boundary is the step's barrier):
//  - gru_wide_fwd_kernel: block (jx, bt, d) takes units 16 jx.. and batch
//    rows 64 bt.. of direction d at step k: gh = E(h_prev) @ U_h[:, its 48
//    columns] in a 3-stage ring of 64-wide k chunks (E(h_prev) from the E
//    ping-pong copy [2, B, H] the step before wrote, the U_h columns
//    through L2), 8 warps of (16 rows, one n8 half of the 16 units) x 3
//    gates, mma.sync m16n8k16 (mma_sync.cuh) from a zero accumulator, k
//    ascending; each lane applies the cell to its 4 elements from the
//    accumulators and writes hseq[t], hT at the last step and the E copy.
//  - the BPTT, 2T + 2 launches: gru_wide_round_kernel writes the E copy of
//    every pre-step state once; gru_wide_dgx_kernel recomputes gh on the
//    same ring and tiles, then forms dgx_t, the E gate cotangents G_t =
//    (da_r, da_z, dgh_n), the part of dh_prev that does not go through U_h
//    and the per-16-row dgh_n partials; gru_wide_carry_kernel (every step
//    but the last) adds G_t @ U_h^T gate by gate, dh = ((part + P_r) +
//    P_z) + P_n, on the same ring (G_t's 64-column chunks and U_h's 16 rows
//    of the block's units); then gru_bwd_step.cuh's gru_duh_pipe_kernel
//    (dU_h) and gru_dbhn_kernel (db_hn in step order), as K3 runs them.
//
// Each kernel takes the arguments of two recurrences and picks its own
// with blockIdx.z (blockIdx.y for the copy): K1/K3 launch one direction,
// K6/K7 two. A block's work depends only on its own direction's arguments,
// so each direction of a two-direction call gives the bits of a
// one-direction call. No atomics: the result is deterministic. Padding: the
// wrappers pad H to 16 (forward) or 64 (BPTT) with zero units, which stay
// exactly 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "gru_bwd_step.cuh"  // gru_duh_pipe_kernel, gru_dbhn_kernel,
                             // mma_sync.cuh and elem16.cuh

namespace {
namespace wide {

constexpr int kRows = 64;       // batch rows of a block
constexpr int kUnits = 16;      // hidden units of a block
constexpr int kThreads = 256;   // 8 warps: (16 rows, n8 half) each
constexpr int kKc = 64;         // k of a ring stage
constexpr int kStages = 3;      // depth of the cp.async ring
constexpr int kALd = kKc + 8;   // A stage [64][72] E: 9 16-byte units a row
constexpr int kGLd = 3 * kUnits + 8;  // gh's B stage [64 k][56] E: 7 units
constexpr int kCLd = 3 * kUnits + 4;  // gh in f32 [64][52] after the ring
// A stage and the larger of the two B stages (gh's [64][56], the carry's
// U_h rows [16][72]).
constexpr size_t kStageBytes =
    static_cast<size_t>(kRows) * kALd * 2 + static_cast<size_t>(kKc) * kGLd * 2;
constexpr size_t kRingBytes = kStages * kStageBytes;
constexpr size_t kRsBytes = static_cast<size_t>(kRows) * kUnits * 4;
constexpr size_t kFwdSmem = kRingBytes;
constexpr size_t kDgxSmem = kRingBytes + kRsBytes;
static_assert(static_cast<size_t>(kRows) * kCLd * 4 <= kRingBytes,
              "gh in f32 reuses the ring after the mainloop");
static_assert(kUnits * kALd <= kKc * kGLd, "the carry's B stage fits");

__device__ __forceinline__ float wsigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One direction's forward at step k.
template <class E>
struct Fwd {
  const float* gx;   // [T, B, 3H]
  const int* lens;   // [B]
  const E* uh;       // [H, 3H]
  const float* bhn;  // [H]
  float* hseq;       // [T, B, H]
  float* hT;         // [B, H]
  E* hbf;            // [2, B, H] E copies of the state (ping-pong)
  int T, B, H, reverse;
};

// One direction's BPTT.
template <class E>
struct Bwd {
  const float* gx;    // [T, B, 3H]
  const float* hseq;  // [T, B, H] f32 (the forward's states)
  E* hbf;             // [T, B, H] E copy of the pre-step states
  const int* lens;    // [B]
  const E* uh;        // [H, 3H]
  const float* bhn;   // [H]
  float* dh;          // [B, H]: the carried cotangent, in/out
  float* dpart;       // [B, H]: its part that skips U_h^T
  float* dgx;         // [T, B, 3H]
  E* g;               // [T, B, 3H] E gate cotangents
  float* part;        // [T, ceil(B/16), H] dgh_n partials
  int T, B, H, reverse;
};

// Warp w's task: rows 16 (w / 2).. of the block's 64, n8 half w % 2 of its
// 16 units, all three gates.
struct Lane {
  int rg, half, er, jl;
  __device__ explicit Lane(int warp, int lane)
      : rg(warp >> 1),
        half(warp & 1),
        er((warp >> 1) * 16 + (lane >> 2)),
        jl((warp & 1) * 8 + 2 * (lane & 3)) {}
};

// gh = E(h_prev) @ U_h for the block's rows b0.. (of B) and the 48 columns
// {j0, H+j0, 2H+j0} + 0..15, k ascending in 16-steps, into acc[g] (the
// warp's m16n8 tile of gate g). `hb` [B, H] E, or null for the zero state
// (acc stays 0). H % 16 == 0; the ring's A rows past B and k past H are
// zero-filled.
template <class E>
__device__ __forceinline__ void gh_mainloop(const E* hb, const E* uh, int B,
                                            int H, int b0, int j0,
                                            unsigned char* ring,
                                            const Lane& w, int lane,
                                            float (&acc)[3][4]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
  if (hb == nullptr) return;
  const int tid = threadIdx.x;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int nchunk = (H + kKc - 1) / kKc;
  auto load = [&](int c, int slot) {
    E* As = reinterpret_cast<E*>(ring + slot * kStageBytes);
    E* Bs = As + kRows * kALd;
    for (int i = tid; i < kRows * (kKc / 8); i += kThreads) {
      const int r = i >> 3;
      const int q = (i & 7) * 8;
      const int b = b0 + r;
      const int k = c * kKc + q;
      const bool ok = b < B && k < H;
      cp_async16(As + r * kALd + q, ok ? hb + static_cast<size_t>(b) * H + k
                                       : hb, ok);
    }
    for (int i = tid; i < kKc * 6; i += kThreads) {
      const int kr = i / 6;
      const int s = i - kr * 6;
      const int g = s >> 1;
      const int q = (s & 1) * 8;
      const int k = c * kKc + kr;
      const bool ok = k < H;
      cp_async16(Bs + kr * kGLd + g * kUnits + q,
                 ok ? uh + static_cast<size_t>(k) * H3 + g * H + j0 + q : uh,
                 ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunk) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nchunk; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = c + kStages - 1;
    if (nx < nchunk) load(nx, nx % kStages);
    cp_async_commit();
    const E* As =
        reinterpret_cast<const E*>(ring + (c % kStages) * kStageBytes);
    const E* Bs = As + kRows * kALd;
    const int kend = min(kKc, H - c * kKc);
    for (int kk = 0; kk < kend; kk += 16) {
      unsigned a[4];
      load_a(a, As + w.rg * 16 * kALd + kk, kALd, lane);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        unsigned b[2];
        load_b_half_kmajor(b, Bs + kk * kGLd + g * kUnits + w.half * 8, kGLd,
                           lane);
        mma16816<E>(acc[g], a, b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
}

// One step of the forward: h' = cell(gx, gh, h_prev) where t < lens[b].
template <class E>
__global__ void __launch_bounds__(kThreads)
gru_wide_fwd_kernel(Fwd<E> d0, Fwd<E> d1, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Fwd<E> p = blockIdx.z == 0 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int t = p.reverse ? p.T - 1 - k : k;
  const int lane = threadIdx.x & 31;
  const Lane w(threadIdx.x >> 5, lane);
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  // null at the first step: the zero initial state.
  const E* hb = k == 0 ? nullptr : p.hbf + ((k + 1) & 1) * BH;
  const float* hf =
      k == 0 ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * BH;
  float acc[3][4];
  gh_mainloop<E>(hb, p.uh, B, H, b0, j0, smem, w, lane, acc);

  const int j = j0 + w.jl;
  const float bhn0 = __ldg(p.bhn + j);
  const float bhn1 = __ldg(p.bhn + j + 1);
  float* ho = p.hseq + t * BH;
  E* hbo = p.hbf + (k & 1) * BH;
  float* hTo = k == p.T - 1 ? p.hT : nullptr;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = b0 + w.er + 8 * e;
    if (b >= B) continue;
    const size_t o = static_cast<size_t>(b) * H + j;
    const float2 hp = hf != nullptr
                          ? *reinterpret_cast<const float2*>(hf + o)
                          : make_float2(0.0f, 0.0f);
    const bool live = t < __ldg(p.lens + b);
    const float* x = p.gx + static_cast<size_t>(t) * B * H3 + b * H3 + j;
    float hv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float hpu = u == 0 ? hp.x : hp.y;
      const float bh = u == 0 ? bhn0 : bhn1;
      const float r = wsigmoid(__fadd_rn(x[u], acc[0][2 * e + u]));
      const float z = wsigmoid(__fadd_rn(x[H + u], acc[1][2 * e + u]));
      const float n = tanhf(__fadd_rn(
          x[2 * H + u], __fmul_rn(r, __fadd_rn(acc[2][2 * e + u], bh))));
      const float hn = __fadd_rn(__fmul_rn(1.0f - z, n), __fmul_rn(z, hpu));
      hv[u] = live ? hn : hpu;
    }
    const float2 h = make_float2(hv[0], hv[1]);
    *reinterpret_cast<float2*>(ho + o) = h;
    if (hTo != nullptr) *reinterpret_cast<float2*>(hTo + o) = h;
    *reinterpret_cast<typename Elem<E>::pair*>(hbo + o) =
        Elem<E>::from2(h.x, h.y);
  }
}

// The E copy of the pre-step states: hseq[0..T-2] (forward) or
// hseq[1..T-1] (reverse), rounded as the plain version rounds h_prev.
// blockIdx.y picks the direction. H % 4 == 0.
template <class E>
__global__ void __launch_bounds__(kThreads)
gru_wide_round_kernel(Bwd<E> d0, Bwd<E> d1) {
  const Bwd<E> p = blockIdx.y == 0 ? d0 : d1;
  const size_t BH = static_cast<size_t>(p.B) * p.H;
  const size_t off = p.reverse ? BH : 0;
  const float4* src = reinterpret_cast<const float4*>(p.hseq + off);
  using Pair = typename Elem<E>::pair;
  Pair* dst = reinterpret_cast<Pair*>(p.hbf + off);
  const size_t n4 = (p.T - 1) * BH / 4;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const float4 h = __ldg(src + i);
    dst[2 * i] = Elem<E>::from2(h.x, h.y);
    dst[2 * i + 1] = Elem<E>::from2(h.z, h.w);
  }
}

// Step k of the BPTT (t from the chain's end): gh recomputed, then the
// gates' cotangents from the carried dh.
template <class E>
__global__ void __launch_bounds__(kThreads)
gru_wide_dgx_kernel(Bwd<E> d0, Bwd<E> d1, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bwd<E> p = blockIdx.z == 0 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const int T = p.T;
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int t = p.reverse ? k : T - 1 - k;
  const bool first = p.reverse ? t == T - 1 : t == 0;
  const size_t tp = static_cast<size_t>(p.reverse ? t + 1 : t - 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Lane w(tid >> 5, lane);
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  float* Cs = reinterpret_cast<float*>(smem);
  float* Rs = reinterpret_cast<float*>(smem + kRingBytes);

  float acc[3][4];
  gh_mainloop<E>(first ? nullptr : p.hbf + tp * BH, p.uh, B, H, b0, j0, smem,
                 w, lane, acc);
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(Cs + (w.er + 8 * e) * kCLd + g * kUnits +
                                 w.jl) =
          make_float2(acc[g][2 * e], acc[g][2 * e + 1]);
  __syncthreads();

  // The elementwise step, 4 rows a thread (gru_bwd_step.cuh's math).
  const int jl = tid & (kUnits - 1);
  const int j = j0 + jl;
  const float bhn_j = __ldg(p.bhn + j);
  const float* hf = first ? nullptr : p.hseq + tp * BH;
  const float* gxt = p.gx + static_cast<size_t>(t) * B * H3;
  float* dgxt = p.dgx + static_cast<size_t>(t) * B * H3;
  E* gt = p.g + static_cast<size_t>(t) * B * H3;
#pragma unroll
  for (int q = 0; q < kRows / 16; ++q) {
    const int bl = (tid >> 4) + 16 * q;
    const int b = b0 + bl;
    float dgh_n = 0.0f;
    if (b < B) {
      const size_t o = static_cast<size_t>(b) * H + j;
      const float* x = gxt + b * H3;
      const float* gh = Cs + bl * kCLd + jl;
      const float dh = p.dh[o];
      const float hp = hf != nullptr ? __ldg(hf + o) : 0.0f;
      const float ghn_b = __fadd_rn(gh[2 * kUnits], bhn_j);
      const float r = wsigmoid(__fadd_rn(__ldg(x + j), gh[0]));
      const float z = wsigmoid(__fadd_rn(__ldg(x + H + j), gh[kUnits]));
      const float n =
          tanhf(__fadd_rn(__ldg(x + 2 * H + j), __fmul_rn(r, ghn_b)));
      const float m = t < __ldg(p.lens + b) ? 1.0f : 0.0f;
      const float dh_new = __fmul_rn(m, dh);
      const float dhp =
          __fadd_rn(__fmul_rn(1.0f - m, dh), __fmul_rn(dh_new, z));
      const float dz = __fmul_rn(dh_new, hp - n);
      const float dn = __fmul_rn(dh_new, 1.0f - z);
      const float da_n = __fmul_rn(dn, 1.0f - __fmul_rn(n, n));
      dgh_n = __fmul_rn(da_n, r);
      const float da_r =
          __fmul_rn(__fmul_rn(__fmul_rn(da_n, ghn_b), r), 1.0f - r);
      const float da_z = __fmul_rn(__fmul_rn(dz, z), 1.0f - z);
      float* dg = dgxt + b * H3;
      dg[j] = da_r;
      dg[H + j] = da_z;
      dg[2 * H + j] = da_n;
      E* go = gt + b * H3;
      go[j] = Elem<E>::from(da_r);
      go[H + j] = Elem<E>::from(da_z);
      go[2 * H + j] = Elem<E>::from(dgh_n);
      p.dpart[o] = dhp;
    }
    Rs[bl * kUnits + jl] = dgh_n;
  }
  __syncthreads();
  if (tid < kRows) {  // dgh_n summed over each 16-row group, in order
    const int nbt = (B + 15) / 16;
    const int grp = tid >> 4;
    const int bt16 = b0 / 16 + grp;
    float sum = 0.0f;
    for (int i = 0; i < 16; ++i) sum += Rs[(grp * 16 + i) * kUnits + jl];
    if (bt16 < nbt)
      p.part[(static_cast<size_t>(k) * nbt + bt16) * H + j] = sum;
  }
}

// Step k's carry: dh = ((dpart + G_t[:, r] U_r^T) + G_t[:, z] U_z^T) +
// G_t[:, n] U_n^T for the block's rows and units, each gate's product k
// ascending in 16-steps from a zero accumulator.
template <class E>
__global__ void __launch_bounds__(kThreads)
gru_wide_carry_kernel(Bwd<E> d0, Bwd<E> d1, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bwd<E> p = blockIdx.z == 0 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int t = p.reverse ? k : p.T - 1 - k;
  const E* gt = p.g + static_cast<size_t>(t) * B * H3;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const Lane w(tid >> 5, lane);
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int nchunk = (H + kKc - 1) / kKc;
  const int nstage = 3 * nchunk;  // gate-major: (g, c) = (s / nchunk, ..)

  // Stage s: columns c*64.. of gate g of G_t's rows, and of U_h's rows
  // j0..j0+15 (U_h^T's columns, n-major).
  auto load = [&](int s, int slot) {
    const int g = s / nchunk;
    const int c = s - g * nchunk;
    E* As = reinterpret_cast<E*>(smem + slot * kStageBytes);
    E* Bs = As + kRows * kALd;
    for (int i = tid; i < kRows * (kKc / 8); i += kThreads) {
      const int r = i >> 3;
      const int q = (i & 7) * 8;
      const int b = b0 + r;
      const int kc = c * kKc + q;
      const bool ok = b < B && kc < H;
      cp_async16(As + r * kALd + q, ok ? gt + b * H3 + g * H + kc : gt, ok);
    }
    for (int i = tid; i < kUnits * (kKc / 8); i += kThreads) {
      const int r = i >> 3;
      const int q = (i & 7) * 8;
      const int kc = c * kKc + q;
      const bool ok = kc < H;
      cp_async16(Bs + r * kALd + q,
                 ok ? p.uh + (j0 + r) * H3 + g * H + kc : p.uh, ok);
    }
  };

  float acc[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstage) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < nstage; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nx = s + kStages - 1;
    if (nx < nstage) load(nx, nx % kStages);
    cp_async_commit();
    const int g = s / nchunk;
    const int c = s - g * nchunk;
    const E* As =
        reinterpret_cast<const E*>(smem + (s % kStages) * kStageBytes);
    const E* Bs = As + kRows * kALd;
    const int kend = min(kKc, H - c * kKc);
    // The gate is uniform over the block; the unrolled branch keeps each
    // accumulator in registers.
#pragma unroll
    for (int gg = 0; gg < 3; ++gg) {
      if (gg != g) continue;
      for (int kk = 0; kk < kend; kk += 16) {
        unsigned a[4], b[4];
        load_a(a, As + w.rg * 16 * kALd + kk, kALd, lane);
        load_b_nmajor(b, Bs + kk, kALd, lane);
        // The warp's n8 half of the 16 units (a select, not an index
        // into the register array).
        const unsigned b0 = w.half ? b[2] : b[0];
        const unsigned b1 = w.half ? b[3] : b[1];
        mma16816<E>(acc[gg], a, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  const int j = j0 + w.jl;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int b = b0 + w.er + 8 * e;
    if (b >= B) continue;
    const size_t o = static_cast<size_t>(b) * H + j;
    const float2 dp = *reinterpret_cast<const float2*>(p.dpart + o);
    float2 dh;
    dh.x = __fadd_rn(__fadd_rn(__fadd_rn(dp.x, acc[0][2 * e]), acc[1][2 * e]),
                     acc[2][2 * e]);
    dh.y = __fadd_rn(
        __fadd_rn(__fadd_rn(dp.y, acc[0][2 * e + 1]), acc[1][2 * e + 1]),
        acc[2][2 * e + 1]);
    *reinterpret_cast<float2*>(p.dh + o) = dh;
  }
}

// The forwards p[0..dirs-1] on `st`: T launches of gru_wide_fwd_kernel,
// each advancing every direction by one step. Counts in *launched the
// kernels that launched; returns the first CUDA error (cleared from the
// runtime).
template <class E>
int fwd_run(const Fwd<E> (&p)[2], int dirs, cudaStream_t st,
            int* launched) {
  *launched = 0;
  const int T = p[0].T;
  const int B = p[0].B;
  const int H = p[0].H;
  cudaError_t e = cudaSuccess;
  if (T < 1 || B < 1 || H < kUnits || H % kUnits != 0 || dirs < 1 ||
      dirs > 2)
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_fwd_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFwdSmem));
  const dim3 grid(H / kUnits, (B + kRows - 1) / kRows, dirs);
  for (int k = 0; e == cudaSuccess && k < T; ++k) {
    gru_wide_fwd_kernel<E><<<grid, kThreads, kFwdSmem, st>>>(p[0], p[1], k);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// The BPTTs p[0..dirs-1] on `st`: the E copy of the pre-step states, then
// for each step the gates' cotangents and (but after the last step) the
// carry, then gru_bwd_step.cuh's dU_h GEMM and db_hn sum of every
// direction: 2T + 2 launches. duh[d] ([H, 3H] f32) and dbhn[d] ([H] f32)
// are direction d's. p[d].dh holds the cotangent of the final state on
// entry and is clobbered. H % 64 == 0. Counts in *launched the kernels
// that launched; returns the first CUDA error (cleared from the runtime).
template <class E>
int bwd_run(const Bwd<E> (&p)[2], float* const (&duh)[2],
            float* const (&dbhn)[2], int dirs, cudaStream_t st,
            int* launched) {
  *launched = 0;
  const int T = p[0].T;
  const int B = p[0].B;
  const int H = p[0].H;
  cudaError_t e = cudaSuccess;
  if (T < 1 || B < 1 || H < 64 || H % 64 != 0 || dirs < 1 || dirs > 2)
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_dgx_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDgxSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_carry_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kFwdSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_duh_pipe_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDuhSmem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t n4 = (T - 1) * BH / 4;
  const int rblocks = static_cast<int>(
      std::min<size_t>((n4 + kThreads - 1) / kThreads, 4096));
  if (rblocks > 0) {
    gru_wide_round_kernel<E><<<dim3(rblocks, dirs), kThreads, 0, st>>>(p[0],
                                                                      p[1]);
  } else {
    gru_wide_round_kernel<E><<<dim3(1, dirs), kThreads, 0, st>>>(p[0], p[1]);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  const dim3 grid(H / kUnits, (B + kRows - 1) / kRows, dirs);
  for (int k = 0; e == cudaSuccess && k < T; ++k) {
    gru_wide_dgx_kernel<E><<<grid, kThreads, kDgxSmem, st>>>(p[0], p[1], k);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    ++*launched;
    if (k == T - 1) break;  // the chain's start: no dh_prev is read
    gru_wide_carry_kernel<E><<<grid, kThreads, kFwdSmem, st>>>(p[0], p[1],
                                                               k);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e == cudaSuccess) {
    // h_prev of step t is hseq[t-1] (forward) or hseq[t+1] (reverse); the
    // first processed step's zero state adds nothing and is left out.
    const size_t step_gx = 3 * BH;
    DuhPipe<E> d[2];
    for (int i = 0; i < 2; ++i) {
      d[i] = DuhPipe<E>{p[i].hbf + (p[i].reverse ? BH : 0),
                        p[i].g + (p[i].reverse ? 0 : step_gx), duh[i],
                        (T - 1) * B, H};
    }
    gru_duh_pipe_kernel<E><<<dim3(3 * H / kDN, (H + kDM - 1) / kDM, dirs),
                             kThreads, kDuhSmem, st>>>(d[0], d[1]);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e == cudaSuccess) {
    const int nbt = (B + 15) / 16;
    gru_dbhn_kernel<<<dim3((H + 255) / 256, dirs), 256, 0, st>>>(
        DbhnSum{p[0].part, dbhn[0]}, DbhnSum{p[1].part, dbhn[1]}, T * nbt,
        H);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace wide
}  // namespace
