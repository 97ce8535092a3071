// P1 `probe_mxu_rows`: the tensor-core ceiling of the store-row score GEMM,
// for Hopper (sm_90a).
//
// Replaces tools/probe_mxu_rows.py::make_call.kernel, the TPU probe that
// asked whether Q questions' store rows batched into one [Q*Np, C] x [C, H]
// product fill the TPU's matrix unit better than Q products of Np rows. Here
// the same work: rows [B] index a store [M, Np, C] bf16; group i of Q
// questions computes
//
//   out[i] = concat_q store[rows[i*Q + q]]  @  wv      [Q*Np, H] f32
//
// with f32 sums of bf16 products. The H100 form of the question is 128-row
// tensor-core tiles inside a group: Np=200 rows take 2 tiles (78% of the
// rows useful), 400 take 4 (78%), 600 take 5 (94%), 800 take 7 (89%).
//
// The mainloop is K4's score mainloop, score_gemm.cuh: 128-row x BN-column
// tiles on wgmma (BN 256 where it divides H, else 128), a cp.async ring of
// 64-channel chunks, each row's address from its question's row index, the
// rows past a group's end zero-filled. The epilogue only writes the f32
// tile from the accumulator registers, so the probe times the mainloop
// alone against cuBLAS on the same product.
//
// What bounds it on an H100: at B=252, Np=200, C=2048, H=512 the product is
// 105.7 GFLOP of bf16 (107 us at 989 TFLOP/s) against 52 MB of store (64
// rows), 2 MB of wv and 103 MB of f32 output (47 us at 3.35 TB/s): the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "score_gemm.cuh"

namespace {

using score_gemm::kBM;

// Tile row r is row row0 + r of group `group`'s product: cell n of
// question q of the group, zero past the group's Q * Np rows.
struct GroupRows {
  const __nv_bfloat16* store;
  const int* rows;
  int Q, Np, C, grows, group, row0;
  __device__ const __nv_bfloat16* operator()(int r) const {
    const int gr = row0 + r;
    if (gr >= grows) return nullptr;
    const int q = gr / Np;
    return store +
           (static_cast<size_t>(rows[group * Q + q]) * Np + (gr - q * Np)) * C;
  }
};

template <int BN>
__global__ void __launch_bounds__(score_gemm::kThreads, 1)
probe_rows_kernel(const __nv_bfloat16* __restrict__ store,  // [M, Np, C]
                  const int* __restrict__ rows,             // [B]
                  const __nv_bfloat16* __restrict__ wvt,    // [H, C]
                  float* __restrict__ out,                  // [B/Q, Q*Np, H]
                  int Q, int Np, int C, int H, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = score_gemm::align1024(smem_raw);
  const int t = threadIdx.x;
  const int group = blockIdx.y / tiles;
  const int row0 = (blockIdx.y - group * tiles) * kBM;
  const int col0 = blockIdx.x * BN;
  const int grows = Q * Np;  // rows of the group's product

  float acc[BN / 2];
  float sq[4];
  score_gemm::mainloop<__nv_bfloat16, BN>(
      GroupRows{store, rows, Q, Np, C, grows, group, row0}, wvt, C, col0,
      ring, acc, sq, false);

  // The tile's rows inside the group, 8 bytes a thread per store (a quad
  // writes 32 contiguous bytes of a row).
  const int fr = score_gemm::frag_row(t);
  const int fc = score_gemm::frag_col(t);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + fr + 8 * hf;
    if (r < grows) {
      float* dst = out + (static_cast<size_t>(group) * grows + r) * H + col0 +
                   fc;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

template <int BN>
cudaError_t launch(const void* store, const void* rows, const void* wvt,
                   void* out, int B, int Q, int Np, int C, int H,
                   cudaStream_t st) {
  constexpr int smem = score_gemm::Plan<__nv_bfloat16, BN>::kSmemBytes;
  cudaError_t e = cudaFuncSetAttribute(
      probe_rows_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  const int tiles = (Q * Np + kBM - 1) / kBM;
  const dim3 grid(H / BN, (B / Q) * tiles);
  probe_rows_kernel<BN><<<grid, score_gemm::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(wvt),
      static_cast<float*>(out), Q, Np, C, H, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] bf16, rows [B] i32 (< M), wvt [H, C] bf16 (W_v
// transposed, K-major) -> out [B/Q, Q*Np, H] f32. Needs B % Q == 0,
// C % 32 == 0 and H % 128 == 0 (checked by the caller). One launch on
// `stream`, counted in *launched if it launched; returns the launch error.
int probe_mxu_rows(const void* store, const void* rows, const void* wvt,
                   void* out, int B, int Q, int Np, int C, int H,
                   void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      score_gemm::tile_n(H) == 256
          ? launch<256>(store, rows, wvt, out, B, Q, Np, C, H, st)
          : launch<128>(store, rows, wvt, out, B, Q, Np, C, H, st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
