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
//  1. attn_f32_bwd_dz_ring_kernel: the [B*N, C] x [C, H] product on
//     fp32_ring.cuh's tile loop, 128 cells x 128 units a block over all
//     B*N cells (K2f's score tile: v's rows copied by cp.async, transposed
//     into the f32 slot the products read), 16-channel chunks, two blocks
//     an SM. Its epilogue forms z and writes dz [B*N, H] f32 and, when
//     normalizing, dz * r (rounded, as the plain version rounds it: the B
//     of the dW_v product), and sums ds * relu(z) over the tile's cells, a
//     unit's 16 thread rows added in order through shared memory: one dws
//     partial a tile [tiles, H];
//  2. the dW_v product [C, B*N] x [B*N, H] on fp32_ring.cuh's
//     product_kernel (K5f's), 128 channels x 128 units a block, both
//     operands MN-major (v's rows and dz * r's, copied straight into the
//     layouts the products read), the cells split so that the grid fills
//     the card (the split comes from the wrapper, a function of the shapes
//     and the card: K5f's), each split's sum in cell order;
//  3. attn_f32_bwd_reduce_kernel: dW_v's splits summed in split order, each
//     question's dqh summed over its cells in order, dws over the tiles in
//     order.
// The two products' copy widths (16, 8 or 4 bytes as v's pitch C * 4 and
// address allow) come from the wrapper's ops/kernels.py::f32_ring_plan.
// Any C, H and N. No atomics: two calls give the same bits.

#include <cuda_runtime.h>

#include "fp32_ring.cuh"
#include "store_rows_f32.cuh"

namespace {

constexpr int TILE = fp32_ring::TILE;  // cells and units of a dz tile
constexpr int SPLIT_ROUND = 8;  // a split's cells: a multiple of 8 but
                                // the last (the wrapper's rule)

template <int WA, int WB>
__global__ void __launch_bounds__(fp32_ring::THREADS, 2)
    attn_f32_bwd_dz_ring_kernel(const float* __restrict__ v,
                                const float* __restrict__ wv,
                                const float* __restrict__ qh,
                                const float* __restrict__ ws,
                                const float* __restrict__ ds,
                                const float* __restrict__ rnorm,
                                float* __restrict__ dz,
                                float* __restrict__ dzr,
                                float* __restrict__ wpart, int cells, int N,
                                int C, int H, int wa, int wb) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T8 = TILE / 16;
  float acc[T8][T8] = {};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  fp32_ring::mainloop<float, true, WA, WB>(rows_f32::GridCells{v, N, C}, wv,
                                          H, cells, H, m0, n0, 0, C, wa, wb,
                                          acc, smem);
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
      const float g = z > 0.f ? __fmul_rn(d, ws[n]) : 0.f;
      dz[(long long)m * H + n] = g;
      if (dzr != nullptr) dzr[(long long)m * H + n] = __fmul_rn(g, r);
      dw[j] = fmaf(d, fmaxf(z, 0.f), dw[j]);
    }
  }
  // A tile's dws sums by thread row, in the ring's memory: every thread is
  // done with the last chunk once it passes the barrier.
  __syncthreads();
  float(*red)[TILE] = reinterpret_cast<float(*)[TILE]>(smem);
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
// dws [H], all f32. Scratch: dz [B*N, H], dzr [B*N, H] (when normalize;
// else unread), wpart [ceil(B*N/128), H], part [splits, C, H], all f32.
// The two products' plans, ops/kernels.py::f32_ring_plan's: copy widths
// (bytes) and shared bytes of the dz launch (wa_dz, wb_dz, smem_dz) and of
// the dW_v launch (wa_dwv, wb_dwv, smem_dwv), and the stages, refused where
// v's alignment does not allow them. Three launches on `stream`, added to
// *launched.
int attention_bwd_f32(const float* v, const float* wv, const float* qh,
                      const float* ws, const float* ds, const float* r,
                      float* dz, float* dzr, float* wpart, float* part,
                      float* dqh,
                      float* dwv, float* dws, int B, int N, int C, int H,
                      int normalize, int splits, int wa_dz, int wb_dz,
                      int smem_dz, int wa_dwv, int wb_dwv, int smem_dwv,
                      int stages, cudaStream_t stream, int* launched) {
  if (splits < 1 ||
      !fp32_ring::plan_ok<float, true>(wa_dz, wb_dz, stages, smem_dz,
                                              v, (long long)C * 4, wv,
                                              (long long)H * 4) ||
      !fp32_ring::plan_ok<float, false>(wa_dwv, wb_dwv, stages, smem_dwv,
                                        v, (long long)C * 4,
                                        normalize ? dzr : dz,
                                        (long long)H * 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cells = B * N;
  const int tiles = (cells + TILE - 1) / TILE;
  const float* rn = normalize ? r : nullptr;
  float* dzr_out = normalize ? dzr : nullptr;
  cudaError_t err = fp32_ring::by_plan(wa_dz, wb_dz, [&](auto fa, auto fb) {
    auto* kernel =
        attn_f32_bwd_dz_ring_kernel<decltype(fa)::value, decltype(fb)::value>;
    cudaError_t e = fp32_ring::opt_in(kernel, smem_dz);
    if (e != cudaSuccess) return e;
    kernel<<<dim3((H + TILE - 1) / TILE, tiles), fp32_ring::THREADS, smem_dz,
             stream>>>(v, wv, qh, ws, ds, rn, dz, dzr_out, wpart, cells, N,
                       C, H, wa_dz, wb_dz);
    ++*launched;
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (cells + splits - 1) / splits;
  const int chunk = (per + SPLIT_ROUND - 1) / SPLIT_ROUND * SPLIT_ROUND;
  err = fp32_ring::launch_product<float>(
      rows_f32::GridCells{v, N, C}, normalize ? dzr : dz, H, C, H, cells,
      chunk, splits, part, H, wa_dwv, wb_dwv, smem_dwv, stream, launched);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long CH = (long long)C * H;
  const long long total = CH + (long long)B * H + H;
  attn_f32_bwd_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                               stream>>>(part, splits, dz, wpart, tiles, dwv,
                                         dqh, dws, CH, B, N, H);
  ++*launched;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
