// gru_step_f32.cuh: one timestep of the float32 GRU recurrence, the step of
// K1f (the forward, csrc/gru_fwd_f32.cu) and of K3f (the BPTT,
// csrc/gru_bwd_f32.cu, which recomputes the gates), and of K6f and K7f,
// which take both chains of a bidirectional GRU in each launch
// (csrc/bigru_fwd_f32.cu, csrc/bigru_bwd_f32.cu); and the db_hn sum of K3f
// and K7f. For Hopper (sm_90a).
//
// A block owns BM = 64 batch rows x UNITS = 16 hidden units and computes
// the three gate columns of each of its units, gh = h_prev @ U_h, on
// fp32_tile.cuh's tile loop over a regrouped column space: tile column
// v = 3u + g reads U_h's column g*H + u, so thread tx holds the r, z and n
// products of unit u0 + tx for its 4 rows in registers, and the gate math
// runs on them in the epilogue with no trip through memory:
//
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r * (gh_n + b_hn)),  h' = (1 - z) * n + z * h
//   h_t = t < lens[b] ? h' : h
//
// The BPTT epilogue forms the step's cotangents from the carried dh as
// gru_bwd_reference does: dgx_t = (da_r, da_z, da_n), the gate cotangents
// g_t = (da_r, da_z, dgh_n) for the U_h^T product and dU_h, and the part of
// dh_prev that does not go through U_h, (1 - m) dh + m dh z.
//
// Full-precision expf and tanhf, products and sums rounded apart where the
// plain version rounds them apart (__fmul_rn / __fadd_rn), no fast math.

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

// One step t over all rows, the block's 64 rows x 16 units at (blockIdx.y,
// blockIdx.x). gx [B, 3H] is step t's hoisted x@W_x + b, hprev [B, H] the
// state before it (null at the chain's first step: zeros). Forward (BWD
// false): hout [B, H] = the state after step t (hseq[t]), and hT too when
// not null. Backward: dh [B, H] the carried cotangent of the state after
// step t -> dgx [B, 3H], gq [B, 3H] and dpart [B, H]. K1f's and K3f's step
// kernel and K6f's and K7f's (both chains, the direction on blockIdx.z)
// call it, so every chain runs the same arithmetic.
template <bool BWD>
__device__ __forceinline__ void step(
    const float* __restrict__ gx, const float* __restrict__ hprev,
    const int* __restrict__ lens, int t, const float* __restrict__ uh,
    const float* __restrict__ bhn, int B, int H, float* __restrict__ hout,
    float* __restrict__ hT, const float* __restrict__ dh,
    float* __restrict__ dgx, float* __restrict__ gq,
    float* __restrict__ dpart, fp32_tile::Smem<BM, BN, BK>& s) {
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
    const float r = sigmoid(__fadd_rn(g[u], acc[i][0]));
    const float z = sigmoid(__fadd_rn(g[H + u], acc[i][1]));
    const float ghn = __fadd_rn(acc[i][2], bhn[u]);
    const float n = tanhf(__fadd_rn(g[2 * H + u], __fmul_rn(r, ghn)));
    const bool live = t < lens[b];
    const long long o = (long long)b * H + u;
    if (!BWD) {
      const float hn = __fadd_rn(__fmul_rn(1.f - z, n), __fmul_rn(z, hp));
      const float h = live ? hn : hp;
      hout[o] = h;
      if (hT != nullptr) hT[o] = h;
    } else {
      const float d = dh[o];
      const float dnew = live ? d : 0.f;
      const float dz = __fmul_rn(dnew, hp - n);
      const float dn = __fmul_rn(dnew, 1.f - z);
      const float da_n = __fmul_rn(dn, 1.f - __fmul_rn(n, n));
      const float dgh_n = __fmul_rn(da_n, r);
      const float da_r =
          __fmul_rn(__fmul_rn(__fmul_rn(da_n, ghn), r), 1.f - r);
      const float da_z = __fmul_rn(__fmul_rn(dz, z), 1.f - z);
      float* dg = dgx + b * H3;
      dg[u] = da_r;
      dg[H + u] = da_z;
      dg[2 * H + u] = da_n;
      float* q = gq + b * H3;
      q[u] = da_r;
      q[H + u] = da_z;
      q[2 * H + u] = dgh_n;
      dpart[o] = live ? __fmul_rn(d, z) : d;
    }
  }
}

// K1f's and K3f's step kernel: step() on one chain.
template <bool BWD>
__global__ void __launch_bounds__(fp32_tile::THREADS)
    gru_f32_step_kernel(const float* __restrict__ gx,
                        const float* __restrict__ hprev,
                        const int* __restrict__ lens, int t,
                        const float* __restrict__ uh,
                        const float* __restrict__ bhn, int B, int H,
                        float* __restrict__ hout, float* __restrict__ hT,
                        const float* __restrict__ dh,
                        float* __restrict__ dgx, float* __restrict__ gq,
                        float* __restrict__ dpart) {
  __shared__ fp32_tile::Smem<BM, BN, BK> s;
  step<BWD>(gx, hprev, lens, t, uh, bhn, B, H, hout, hT, dh, dgx, gq, dpart,
            s);
}

constexpr int SUM_ROWS = 8;  // row strides a unit of the db_hn sum

// dbhn[j] = sum over `rows` rows of gq[:, 2H + j], eight row strides a unit
// added in a fixed order; blocks of blockIdx.y 1 sum gq1 into dbhn1 (the
// second chain of K7f; K3f launches one row of blocks).
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
  if (j < H)
    for (int r = threadIdx.y; r < rows; r += SUM_ROWS)
      acc += gq[(long long)r * 3 * H + 2 * H + j];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < H) {
    float sum = 0.f;
    for (int w = 0; w < SUM_ROWS; ++w) sum += part[w][threadIdx.x];
    dbhn[j] = sum;
  }
}

}  // namespace gru_f32
