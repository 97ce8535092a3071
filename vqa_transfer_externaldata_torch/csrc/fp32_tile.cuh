// fp32_tile.cuh: the float32 tile loop of the float32 GRU's forward step
// form (K1f's and K6f's step kernel, gru_step_f32.cuh), on the FP32 pipes
// (FFMA), for Hopper (sm_90a). The float32 attention products (K2f, K4f,
// K5f, K8f) and the BPTT's gh and dU_h products (K3f, K7f) run
// fp32_ring.cuh's loop; the BPTT's step form, gru_bptt_f32.cuh's.
//
// The float32 path of the port exists to meet a float64 oracle to 1e-4
// (the checkpoint-fidelity path), so its products take no TF32 or bf16
// tensor-core pass: every product is an FFMA with an f32 sum. A block of
// 256 threads (16 x 16) owns a BM x BN tile of C = A x B and walks k in
// chunks of BK (a template parameter: 8 to 32), staging the chunk's A [BM x
// BK] and B [BK x BN] in shared memory while the next chunk's loads wait
// in registers (issued before the chunk's products, so their latency
// overlaps the FFMAs); thread (ty, tx) keeps the TM x TN sums of rows
// ty*TM .. and columns tx*TN .. in registers (TM = BM / 16, TN = BN / 16).
// Each sum takes its k in increasing order from a zero start, so a
// product is a fixed function of its inputs: two calls give the same
// bits.
//
// Operands are read through functors, `A(m, k)` and `B(k, n)`, which
// return a float, so a caller reads its operands where they lie: U_h with
// its gate columns regrouped. The loads put neighbouring threads on
// neighbouring addresses along the operand's contiguous index (A_ALONG_K /
// B_ALONG_K). Entries at m >= M or n >= N, and k outside [k0, k1), read as
// 0, so no shape needs to be a multiple of a tile.
//
// What bounds it: the FP32 pipes (67 TFLOP/s on an H100 SXM). A simple
// loop, right first: one shared-memory buffer, scalar loads; its rate is
// in PERF.md.

#pragma once

#include <cuda_runtime.h>

namespace fp32_tile {

constexpr int THREADS = 256;  // 16 x 16 threads a block

// A chunk's operands in shared memory, k-major, each row padded by 4
// floats so that a warp's stores spread over the banks.
template <int BM, int BN, int BK>
struct Smem {
  float a[BK][BM + 4];
  float b[BK][BN + 4];
};

// Thread `tid`'s share of a chunk's loads of one operand: the r-th element
// it takes is idx = tid + r * THREADS of the chunk's BR x BK (rows x k)
// elements, ordered so that neighbouring threads take neighbouring
// addresses along the operand's contiguous index (ALONG_K: k).
template <int BR, int BK, bool ALONG_K>
struct Share {
  static constexpr int N = (BR * BK + THREADS - 1) / THREADS;
  __device__ __forceinline__ static bool at(int tid, int r, int& row,
                                            int& k) {
    const int idx = tid + r * THREADS;
    row = ALONG_K ? idx / BK : idx % BR;
    k = ALONG_K ? idx % BK : idx / BR;
    return idx < BR * BK;
  }
};

template <int BM, int BN, int BK, bool A_ALONG_K, bool B_ALONG_K,
          class ALoad, class BLoad>
__device__ __forceinline__ void mainloop(const ALoad& A, const BLoad& B,
                                         int M, int N, int m0, int n0,
                                         int k0, int k1,
                                         float (&acc)[BM / 16][BN / 16],
                                         Smem<BM, BN, BK>& s) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert(TM * 16 == BM && TN * 16 == BN, "tile of 16 x 16 threads");
  using SA = Share<BM, BK, A_ALONG_K>;
  using SB = Share<BN, BK, B_ALONG_K>;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // The next chunk's operands wait in registers while this chunk's
  // products run, so their loads' latency overlaps the FFMAs.
  float ra[SA::N], rb[SB::N];
  auto fetch = [&](int kc) {
#pragma unroll
    for (int r = 0; r < SA::N; ++r) {
      int m, k;
      const bool in = SA::at(tid, r, m, k);
      ra[r] = (in && m0 + m < M && kc + k < k1) ? A(m0 + m, kc + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < SB::N; ++r) {
      int n, k;
      const bool in = SB::at(tid, r, n, k);
      rb[r] = (in && n0 + n < N && kc + k < k1) ? B(kc + k, n0 + n) : 0.f;
    }
  };
  if (k0 < k1) fetch(k0);
  for (int kc = k0; kc < k1; kc += BK) {
#pragma unroll
    for (int r = 0; r < SA::N; ++r) {
      int m, k;
      if (SA::at(tid, r, m, k)) s.a[k][m] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < SB::N; ++r) {
      int n, k;
      if (SB::at(tid, r, n, k)) s.b[k][n] = rb[r];
    }
    __syncthreads();
    if (kc + BK < k1) fetch(kc + BK);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = s.a[k][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = s.b[k][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace fp32_tile
