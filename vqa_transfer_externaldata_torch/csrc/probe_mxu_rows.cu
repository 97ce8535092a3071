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
// with f32 sums of bf16 products. The H100 form of the question is 64-row
// tensor-core tiles inside a group: Np=200 rows take 4 tiles (78% of the
// rows useful), 400 take 7 (89%), 600 take 10 (94%), 800 take 13 (96%).
//
// The mainloop is K4's score mainloop (attention_resident_fwd.cu): blocks
// own 64-row x 128-column tiles, bf16 WMMA, the next k-step's tiles loaded
// into registers while the tensor cores work on the current one, each
// thread computing the store address of the row it stages from the row
// index. There is no epilogue beyond writing the f32 tile, so the probe
// times how much of K4's score kernel the mainloop is.
//
// What bounds it on an H100: at B=252, Np=200, C=2048, H=512 the product is
// 105.7 GFLOP of bf16 (107 us at 989 TFLOP/s) against 52 MB of store (64
// rows), 2 MB of wv and 103 MB of f32 output (47 us at 3.35 TB/s): the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kBM = 64;    // rows per tile
constexpr int kBN = 128;   // columns per tile
constexpr int kBK = 32;    // channels per k-step
constexpr int kALd = kBK + 8;
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;
constexpr int kThreads = 256;  // 8 warps: 4 row x 2 column groups

__global__ void __launch_bounds__(kThreads)
probe_rows_kernel(const __nv_bfloat16* __restrict__ store,  // [M, Np, C]
                  const int* __restrict__ rows,             // [B]
                  const __nv_bfloat16* __restrict__ wv,     // [C, H]
                  float* __restrict__ out,                  // [B/Q, Q*Np, H]
                  int Q, int Np, int C, int H, int tiles) {
  __shared__ __align__(128) __nv_bfloat16 As[kBM * kALd];
  __shared__ __align__(128) __nv_bfloat16 Bs[kBK * kBLd];
  __shared__ __align__(128) float Cs[kBM * kCLd];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;  // rows wr*16 .. +16 of the tile
  const int wc = warp & 1;   // columns wc*64 .. +64 of the tile
  const int group = blockIdx.x / tiles;
  const int row0 = (blockIdx.x - group * tiles) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int grows = Q * Np;  // rows of the group's product

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // A tile: 64 rows x 32 channels = 256 x 16-byte loads, one per thread,
  // each from the store row of its question.
  const int a_r = tid >> 2;
  const int a_c = (tid & 3) * 8;
  const int a_row = row0 + a_r;
  const bool a_ok = a_row < grows;
  const __nv_bfloat16* a_src = store;
  if (a_ok) {
    const int q = a_row / Np;
    const int n = a_row - q * Np;
    a_src = store + (static_cast<size_t>(rows[group * Q + q]) * Np + n) * C +
            a_c;
  }
  // B tile: 32 rows x 128 columns = 512 x 16-byte loads, two per thread.
  const int b_r = tid >> 4;
  const int b_c = (tid & 15) * 8;
  const __nv_bfloat16* b_src =
      wv + static_cast<size_t>(b_r) * H + col0 + b_c;
  const size_t b_half = static_cast<size_t>(16) * H;

  uint4 a4 = make_uint4(0u, 0u, 0u, 0u);
  if (a_ok) a4 = *reinterpret_cast<const uint4*>(a_src);
  uint4 b4a = *reinterpret_cast<const uint4*>(b_src);
  uint4 b4b = *reinterpret_cast<const uint4*>(b_src + b_half);

  for (int k0 = 0; k0 < C; k0 += kBK) {
    *reinterpret_cast<uint4*>(&As[a_r * kALd + a_c]) = a4;
    *reinterpret_cast<uint4*>(&Bs[b_r * kBLd + b_c]) = b4a;
    *reinterpret_cast<uint4*>(&Bs[(b_r + 16) * kBLd + b_c]) = b4b;
    __syncthreads();
    if (k0 + kBK < C) {  // next k-step's tiles in flight during the MMAs
      const size_t kn = k0 + kBK;
      if (a_ok) a4 = *reinterpret_cast<const uint4*>(a_src + kn);
      b4a = *reinterpret_cast<const uint4*>(b_src + kn * H);
      b4b = *reinterpret_cast<const uint4*>(b_src + kn * H + b_half);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::load_matrix_sync(af, &As[(wr * 16) * kALd + kk], kALd);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bf;
        wmma::load_matrix_sync(bf, &Bs[kk * kBLd + wc * 64 + j * 16], kBLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::store_matrix_sync(&Cs[(wr * 16) * kCLd + wc * 64 + j * 16], acc[j],
                            kCLd, wmma::mem_row_major);
  }
  __syncthreads();
  // The tile's rows inside the group, 16 bytes a thread per store.
  float* dst = out + (static_cast<size_t>(group) * grows + row0) * H + col0;
  for (int i = tid; i < kBM * kBN / 4; i += kThreads) {
    const int r = i / (kBN / 4);
    const int c = (i - r * (kBN / 4)) * 4;
    if (row0 + r < grows) {
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * H + c) =
          *reinterpret_cast<const float4*>(&Cs[r * kCLd + c]);
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// store [M, Np, C] bf16, rows [B] i32 (< M), wv [C, H] bf16 -> out
// [B/Q, Q*Np, H] f32. Needs B % Q == 0, C % 32 == 0 and H % 128 == 0
// (checked by the caller). One launch on `stream`, counted in *launched if
// it launched; returns the launch error.
int probe_mxu_rows(const void* store, const void* rows, const void* wv,
                   void* out, int B, int Q, int Np, int C, int H,
                   void* stream, int* launched) {
  *launched = 0;
  const int tiles = (Q * Np + kBM - 1) / kBM;
  const dim3 grid((B / Q) * tiles, H / kBN);
  probe_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(store),
      static_cast<const int*>(rows), static_cast<const __nv_bfloat16*>(wv),
      static_cast<float*>(out), Q, Np, C, H, tiles);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // extern "C"
