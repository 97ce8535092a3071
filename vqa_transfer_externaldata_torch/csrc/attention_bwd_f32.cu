// K8f `attention_bwd_f32`: the backward of the gathered single-glimpse
// attention in float32 (the parameter cotangents; the grid gets none), for
// Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_bwd_kernel
// (the Pallas body launched by _attention_pallas_bwd) when the model
// computes in float32: the TPU kernel runs in v's dtype, and K8
// (attention_bwd.cu) takes only bf16. The same function as K8's plain
// version attention_bwd_reference on a float32 grid v [B, N, C], from the
// score cotangent ds and the forward's per-cell norm r (K2f's residual),
// for question b, cell n, hidden unit k:
//
//   z_nk  = ((v_n . W_v[:, k]) r_n) + qh_bk        (r = 1 when !normalize)
//   dz_nk = [z_nk > 0] ds_n ws_k
//   dqh_b = sum_n dz_n,   dws = sum_{b,n} ds_n relu(z_n),
//   dW_v  = sum_{b,n} v_n^T (dz_n r_n)
//
// in FFMA with f32 sums: no TF32 or bf16 pass.
//
// What bounds it on an H100: at B=256, N=196, C=2048, H=512 the recomputed
// z and dW_v are 2 x 105.2 GFLOP of f32 FFMA (3.14 ms at 67 TFLOP/s); v is
// read in 0.12 ms at 3.35 TB/s: the FP32 pipes.
//
// Design, three launches in stream order:
//  1. attn_f32_bwd_dz_kernel: the [B*N, C] x [C, H] product on
//     fp32_tile.cuh's tile loop, 128 cells x 128 units a block over all
//     B*N cells (K2f's score tile, v read in place), 8-channel chunks, two
//     blocks an SM. Its epilogue forms z and writes dz [B*N, H] f32, and
//     sums ds * relu(z) over the tile's cells, a unit's 16 thread rows
//     added in order through shared memory: one dws partial a tile [tiles,
//     H];
//  2. the dW_v product [C, B*N] x [B*N, H] on fp32_tile.cuh's
//     product_kernel, 128 channels x 128 units a block, reading dz * r
//     (rounded, as the plain version rounds it) as it loads, the cells split
//     so that the grid fills the card (the split comes from the wrapper, a
//     function of the shapes and the card: K5f's), each split's sum in cell
//     order;
//  3. attn_f32_bwd_reduce_kernel: dW_v's splits summed in split order, each
//     question's dqh summed over its cells in order, dws over the tiles in
//     order.
// Any C, H and N. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "fp32_tile.cuh"
#include "store_rows_f32.cuh"

namespace {

constexpr int TILE = 128;  // cells and units of a dz tile
constexpr int CHUNK = 8;  // channels of a k-chunk of the recomputed product
constexpr int DWV_TILE = 128;  // channels and units of a dW_v tile
constexpr int DWV_CHUNK = 16;  // cells of a k-chunk of the dW_v product
constexpr int SPLIT_ROUND = 8;  // a split's cells: a multiple of 8 but
                                // the last (the wrapper's rule)

// dz [K, H], times r[k] when r is not null (rounded apart): the B of the
// dW_v product, the plain version's dz * r.
struct DzR {
  const float* dz;
  const float* r;
  int H;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const float d = dz[(long long)k * H + n];
    return r != nullptr ? __fmul_rn(d, r[k]) : d;
  }
};

__global__ void __launch_bounds__(fp32_tile::THREADS, 2)
    attn_f32_bwd_dz_kernel(const float* __restrict__ v,
                           const float* __restrict__ wv,
                           const float* __restrict__ qh,
                           const float* __restrict__ ws,
                           const float* __restrict__ ds,
                           const float* __restrict__ rnorm,
                           float* __restrict__ dz, float* __restrict__ wpart,
                           int cells, int N, int C, int H) {
  __shared__ fp32_tile::Smem<TILE, TILE, CHUNK> s;
  __shared__ float red[16][TILE];  // a tile's dws sums by thread row
  constexpr int T8 = TILE / 16;
  float acc[T8][T8] = {};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  fp32_tile::mainloop<TILE, TILE, CHUNK, true, false>(
      rows_f32::GridCells{v, N, C}, fp32_tile::Dense{wv, H}, cells, H, m0,
      n0, 0, C, acc, s);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dw[T8] = {};
#pragma unroll
  for (int i = 0; i < T8; ++i) {
    const int m = m0 + ty * T8 + i;
    if (m >= cells) continue;
    const int b = m / N;
    const float r = rnorm != nullptr ? rnorm[m] : 1.f;
    const float d = ds[m];
#pragma unroll
    for (int j = 0; j < T8; ++j) {
      const int n = n0 + tx * T8 + j;
      if (n >= H) continue;
      const float z =
          __fadd_rn(__fmul_rn(acc[i][j], r), qh[(long long)b * H + n]);
      dz[(long long)m * H + n] = z > 0.f ? __fmul_rn(d, ws[n]) : 0.f;
      dw[j] = fmaf(d, fmaxf(z, 0.f), dw[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < T8; ++j) red[ty][tx * T8 + j] = dw[j];
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < TILE && n < H) {
    float sum = 0.f;
    for (int y = 0; y < 16; ++y) sum += red[y][threadIdx.x];
    wpart[(long long)blockIdx.y * H + n] = sum;
  }
}

// dwv [C*H] = sum over the splits of part [splits, C*H] (in split order);
// dqh [B, H] = sum over each question's N cells of dz [B*N, H] (in cell
// order); dws [H] = sum over the tiles of wpart [tiles, H] (in order).
__global__ void __launch_bounds__(256)
    attn_f32_bwd_reduce_kernel(const float* __restrict__ part, int splits,
                               const float* __restrict__ dz,
                               const float* __restrict__ wpart, int tiles,
                               float* __restrict__ dwv,
                               float* __restrict__ dqh,
                               float* __restrict__ dws, long long CH, int B,
                               int N, int H) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long BH = (long long)B * H;
  float sum = 0.f;
  if (idx < CH) {
    for (int z = 0; z < splits; ++z) sum += part[z * CH + idx];
    dwv[idx] = sum;
  } else if (idx < CH + BH) {
    const long long j = idx - CH;
    const long long b = j / H, n = j - b * H;
    for (int c = 0; c < N; ++c) sum += dz[(b * N + c) * H + n];
    dqh[j] = sum;
  } else if (idx < CH + BH + H) {
    const long long n = idx - CH - BH;
    for (int t = 0; t < tiles; ++t) sum += wpart[(long long)t * H + n];
    dws[n] = sum;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// v [B, N, C] f32, wv [C, H] f32, qh [B, H] f32, ws [H] f32, ds [B, N] f32
// and r [B, N] f32 (read only when normalize) -> dqh [B, H], dwv [C, H],
// dws [H], all f32. Scratch: dz [B*N, H], wpart [ceil(B*N/128), H], part
// [splits, C, H], all f32. Three launches on `stream`, added to *launched.
int attention_bwd_f32(const float* v, const float* wv, const float* qh,
                      const float* ws, const float* ds, const float* r,
                      float* dz, float* wpart, float* part, float* dqh,
                      float* dwv, float* dws, int B, int N, int C, int H,
                      int normalize, int splits, cudaStream_t stream,
                      int* launched) {
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int cells = B * N;
  const int tiles = (cells + TILE - 1) / TILE;
  const float* rn = normalize ? r : nullptr;
  attn_f32_bwd_dz_kernel<<<dim3((H + TILE - 1) / TILE, tiles),
                           fp32_tile::THREADS, 0, stream>>>(
      v, wv, qh, ws, ds, rn, dz, wpart, cells, N, C, H);
  ++*launched;
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int per = (cells + splits - 1) / splits;
  const int chunk = (per + SPLIT_ROUND - 1) / SPLIT_ROUND * SPLIT_ROUND;
  fp32_tile::product_kernel<DWV_TILE, DWV_TILE, DWV_CHUNK, false, false>
      <<<dim3((H + DWV_TILE - 1) / DWV_TILE, (C + DWV_TILE - 1) / DWV_TILE,
              splits),
         fp32_tile::THREADS, 0, stream>>>(
          fp32_tile::DenseT{v, C}, DzR{dz, rn, H}, C, H, cells, chunk,
          nullptr, part, H);
  ++*launched;
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long CH = (long long)C * H;
  const long long total = CH + (long long)B * H + H;
  attn_f32_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(part, splits, dz, wpart, tiles, dwv,
                                         dqh, dws, CH, B, N, H);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
