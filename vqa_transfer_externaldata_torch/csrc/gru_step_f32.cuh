// gru_step_f32.cuh: the float32 GRU's gate math (gates, cell, cell_bwd),
// which every float32 GRU kernel runs, and one timestep of the forward
// recurrence as a launch of its own: the step form of K1f
// (csrc/gru_fwd_f32.cu), taken where its persistent kernel
// (gru_seq_f32.cuh) does not fit, and the step of K6f, which takes both
// chains of a bidirectional GRU in each launch (csrc/bigru_fwd_f32.cu); and
// the db_hn sum of K3f and K7f. The BPTT's step form is gru_bptt_f32.cuh's.
// For Hopper (sm_90a).
//
// A step block owns BM = 64 batch rows x UNITS = 16 hidden units and
// computes the three gate columns of each of its units, gh = h_prev @ U_h,
// on fp32_tile.cuh's tile loop over a regrouped column space: tile column
// v = 3u + g reads U_h's column g*H + u, so thread tx holds the r, z and n
// products of unit u0 + tx for its 4 rows in registers, and the gate math
// runs on them in the epilogue with no trip through memory:
//
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r * (gh_n + b_hn)),  h' = (1 - z) * n + z * h
//   h_t = t < lens[b] ? h' : h
//
// The BPTT's gate backward (cell_bwd) forms a step's cotangents from the
// carried dh as gru_bwd_reference does: dgx_t = (da_r, da_z, da_n), the
// gate cotangents g_t = (da_r, da_z, dgh_n) for the U_h^T product and dU_h,
// and the part of dh_prev that does not go through U_h, (1 - m) dh + m dh z.
//
// Full-precision expf and tanhf, products and sums rounded apart where the
// plain version rounds them apart (__fmul_rn / __fadd_rn), no fast math.
// Every kernel that takes the same hidden products (the same FFMA chain, k
// ascending from zero) and calls these functions gives the same bits.

#pragma once

#include "fp32_tile.cuh"

namespace gru_f32 {

constexpr int BM = 64;  // batch rows a block
constexpr int UNITS = 16;  // hidden units a block, three gate columns each
constexpr int BN = 3 * UNITS;
constexpr int BK = 32;  // the k-chunk of the hidden product

// h_prev [B, H] as the product's A (row b, k).
struct HLoad {
  const float* h;
  int H;
  __device__ __forceinline__ float operator()(int b, int k) const {
    return h[(long long)b * H + k];
  }
};

// U_h [H, 3H] with its columns regrouped: column v = 3u + g is U_h's
// column g*H + u, so a unit's three gates are neighbours.
struct UhGates {
  const float* uh;
  int H;
  __device__ __forceinline__ float operator()(int k, int v) const {
    return uh[(long long)k * 3 * H + (v % 3) * H + v / 3];
  }
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The gates of one element: gx's (xr, xz, xn), the hidden products (ghr,
// ghz, ghn: f32 sums of h_prev @ U_h's three columns) and b_hn.
struct Gates {
  float r, z, ghn, n;  // ghn: gh_n + b_hn
};

__device__ __forceinline__ Gates gates(float xr, float xz, float xn,
                                       float ghr, float ghz, float ghn,
                                       float bhn) {
  Gates q;
  q.r = sigmoid(__fadd_rn(xr, ghr));
  q.z = sigmoid(__fadd_rn(xz, ghz));
  q.ghn = __fadd_rn(ghn, bhn);
  q.n = tanhf(__fadd_rn(xn, __fmul_rn(q.r, q.ghn)));
  return q;
}

// The state after the step from h_prev `hp`: h' where `live`, else hp.
__device__ __forceinline__ float cell(const Gates& q, float hp, bool live) {
  const float hn = __fadd_rn(__fmul_rn(1.f - q.z, q.n), __fmul_rn(q.z, hp));
  return live ? hn : hp;
}

// The step's cotangents from d, the carried cotangent of the state after
// it: dgx = (da_r, da_z, da_n), g = (da_r, da_z, dgh_n), and dpart, the
// part of dh_prev that does not go through U_h.
struct Cotangents {
  float da_r, da_z, da_n, dgh_n, dpart;
};

__device__ __forceinline__ Cotangents cell_bwd(const Gates& q, float hp,
                                               float d, bool live) {
  const float dnew = live ? d : 0.f;
  const float dz = __fmul_rn(dnew, hp - q.n);
  const float dn = __fmul_rn(dnew, 1.f - q.z);
  Cotangents c;
  c.da_n = __fmul_rn(dn, 1.f - __fmul_rn(q.n, q.n));
  c.dgh_n = __fmul_rn(c.da_n, q.r);
  c.da_r = __fmul_rn(__fmul_rn(__fmul_rn(c.da_n, q.ghn), q.r), 1.f - q.r);
  c.da_z = __fmul_rn(__fmul_rn(dz, q.z), 1.f - q.z);
  c.dpart = live ? __fmul_rn(d, q.z) : d;
  return c;
}

// One step t of the recurrence over all rows, the block's 64 rows x 16
// units at (blockIdx.y, blockIdx.x). gx [B, 3H] is step t's hoisted x@W_x
// + b, hprev [B, H] the state before it (null at the chain's first step:
// zeros); hout [B, H] = the state after step t (hseq[t]), and hT too when
// not null. K1f's step kernel and K6f's (both chains, the direction on
// blockIdx.z) call it, so every chain runs the same arithmetic.
__device__ __forceinline__ void step(
    const float* __restrict__ gx, const float* __restrict__ hprev,
    const int* __restrict__ lens, int t, const float* __restrict__ uh,
    const float* __restrict__ bhn, int B, int H, float* __restrict__ hout,
    float* __restrict__ hT, fp32_tile::Smem<BM, BN, BK>& s) {
  float acc[BM / 16][BN / 16] = {};
  const int m0 = blockIdx.y * BM, u0 = blockIdx.x * UNITS;
  if (hprev != nullptr)
    fp32_tile::mainloop<BM, BN, BK, true, false>(
        HLoad{hprev, H}, UhGates{uh, H}, B, 3 * H, m0, 3 * u0, 0, H, acc, s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int u = u0 + tx;
  if (u >= H) return;
  const long long H3 = 3LL * H;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int b = m0 + ty * (BM / 16) + i;
    if (b >= B) continue;
    const float* g = gx + b * H3;
    const float hp = hprev != nullptr ? hprev[(long long)b * H + u] : 0.f;
    const Gates q = gates(g[u], g[H + u], g[2 * H + u], acc[i][0], acc[i][1],
                          acc[i][2], bhn[u]);
    const bool live = t < lens[b];
    const long long o = (long long)b * H + u;
    const float h = cell(q, hp, live);
    hout[o] = h;
    if (hT != nullptr) hT[o] = h;
  }
}

// K1f's step kernel: step() on one chain.
__global__ void __launch_bounds__(fp32_tile::THREADS)
    gru_f32_step_kernel(const float* __restrict__ gx,
                        const float* __restrict__ hprev,
                        const int* __restrict__ lens, int t,
                        const float* __restrict__ uh,
                        const float* __restrict__ bhn, int B, int H,
                        float* __restrict__ hout, float* __restrict__ hT) {
  __shared__ fp32_tile::Smem<BM, BN, BK> s;
  step(gx, hprev, lens, t, uh, bhn, B, H, hout, hT, s);
}

constexpr int SUM_ROWS = 8;  // row strides a unit of the db_hn sum

// dbhn[j] = sum over `rows` rows of gq[:, 2H + j], eight row strides a unit
// added in a fixed order; blocks of blockIdx.y 1 sum gq1 into dbhn1 (the
// second chain of K7f; K3f launches one row of blocks). A thread keeps
// AHEAD of its rows' loads in flight and adds them in row order.
__global__ void __launch_bounds__(32 * SUM_ROWS)
    gru_f32_dbhn_kernel(const float* __restrict__ gq0,
                        float* __restrict__ dbhn0,
                        const float* __restrict__ gq1,
                        float* __restrict__ dbhn1, int rows, int H) {
  __shared__ float part[SUM_ROWS][32];
  const float* gq = blockIdx.y == 1 ? gq1 : gq0;
  float* dbhn = blockIdx.y == 1 ? dbhn1 : dbhn0;
  const int j = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (j < H) {
    constexpr int AHEAD = 8;
    const float* col = gq + 2 * H + j;
    const long long ld = 3LL * H;
    int r = threadIdx.y;
    for (; r + (AHEAD - 1) * SUM_ROWS < rows; r += AHEAD * SUM_ROWS) {
      float v[AHEAD];
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) v[a] = col[(r + a * SUM_ROWS) * ld];
#pragma unroll
      for (int a = 0; a < AHEAD; ++a) acc += v[a];
    }
    for (; r < rows; r += SUM_ROWS) acc += col[r * ld];
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < H) {
    float sum = 0.f;
    for (int w = 0; w < SUM_ROWS; ++w) sum += part[w][threadIdx.x];
    dbhn[j] = sum;
  }
}

// The db_hn launch of `chains` chains (gq0 into dbhn0, and gq1 into dbhn1
// for two), `rows` rows of g each; adds one to *launched.
inline cudaError_t dbhn_launch(const float* gq0, float* dbhn0,
                               const float* gq1, float* dbhn1, int chains,
                               int rows, int H, cudaStream_t stream,
                               int* launched) {
  gru_f32_dbhn_kernel<<<dim3((H + 31) / 32, chains), dim3(32, SUM_ROWS), 0,
                        stream>>>(gq0, dbhn0, gq1, dbhn1, rows, H);
  ++*launched;
  return cudaGetLastError();
}

}  // namespace gru_f32
