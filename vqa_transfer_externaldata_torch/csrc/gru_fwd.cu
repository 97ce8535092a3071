// K1 `gru_fwd`: the fused GRU forward recurrence, for Hopper (sm_90a).
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel (the
// Pallas body launched by _gru_pallas_fwd_call); the step math is that
// file's _gru_cell:
//
//   gh = bf16(h) @ U_h                      (f32 accumulation)
//   r  = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z)
//   n  = tanh(gx_n + r * (gh_n + b_hn))
//   h' = (1 - z) * n + z * h                applied only where t < lens[b]
//
// gx = x @ W_x + b is computed once for all steps outside (a plain GEMM).
// `reverse` walks t from T-1 down to 0 under the same prefix mask, so the
// padded tail is processed first and carries the zero state through.
//
// What bounds it on an H100: at B=64, T=26, H=512 the recurrence does
// 2.6 GFLOP and must move about 15 MB (gx in, hseq out, U_h once), which
// the card could do in about 5 us. The real limit is latency: 26 dependent
// steps, each a [B, H] x [H, 3H] product too small to fill the card.
//
// Design: the TPU kernel keeps h in VMEM across a sequential grid and U_h
// (1.5 MB of bf16) resident beside it. No SM holds U_h, and blocks cannot
// carry state between them, so here each timestep is one launch and the
// state lives in device memory (the hseq slot of the previous step, which
// is also the output the backward pass needs). A block owns a 16-row x
// 16-unit tile of h' and so the 48 columns j, H+j, 2H+j of U_h that its
// three gates need. It stages that U_h slice and its 16 rows of h_prev
// (rounded to bf16, as the reference rounds before its matmul) in shared
// memory with 16-byte loads that are all in flight at once, then three
// warps take gh for the r, z and n gates on the tensor cores (bf16 WMMA
// 16x16x16, f32 accumulation), so gh never reaches device memory. Every
// thread then applies the gates and the mask to one element. A first
// version that read U_h straight from L2 in its inner loop spent 79 us a
// step waiting on those dependent loads. One launch for the whole sequence
// (a grid-wide barrier per step, U_h resident in shared memory across the
// SMs) is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;            // batch rows and hidden units per block
constexpr int kCols = 3 * kTile;     // U_h columns per block (r, z, n)
constexpr int kThreads = 256;        // one per element of the output tile
constexpr int kBLd = kCols + 8;      // padded leading dims of the smem
constexpr int kCLd = kCols + 4;      // tiles (32-byte aligned fragments)

__host__ __device__ constexpr int a_ld(int H) { return H + 8; }

__host__ __device__ constexpr size_t smem_bytes(int H) {
  // As [16][H+8] bf16 | Bs [H][56] bf16 | Cs [16][52] f32, 128-aligned.
  return ((static_cast<size_t>(kTile) * a_ld(H) * 2 + 127) / 128) * 128 +
         ((static_cast<size_t>(H) * kBLd * 2 + 127) / 128) * 128 +
         static_cast<size_t>(kTile) * kCLd * 4;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One timestep. h_prev == nullptr means the zero initial state.
__global__ void __launch_bounds__(kThreads)
gru_step_kernel(const float* __restrict__ gx,          // [B, 3H] at step t
                const float* __restrict__ h_prev,      // [B, H] or null
                const __nv_bfloat16* __restrict__ uh,  // [H, 3H]
                const float* __restrict__ bhn,         // [H]
                const int* __restrict__ lens,          // [B]
                float* __restrict__ h_out,             // [B, H] (hseq[t])
                float* __restrict__ h_final,           // [B, H] or null
                int B, int H, int t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = a_ld(H);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(
      smem + ((static_cast<size_t>(kTile) * lda * 2 + 127) / 128) * 128);
  float* Cs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Bs) +
      ((static_cast<size_t>(H) * kBLd * 2 + 127) / 128) * 128);

  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t H3 = 3 * static_cast<size_t>(H);

  // h_prev rows b0..b0+15, rounded to bf16: four floats per load.
  const int q4 = H / 4;
  for (int i = tid; i < kTile * q4; i += kThreads) {
    const int row = i / q4;
    const int c = (i - row * q4) * 4;
    const int b = b0 + row;
    float4 h = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (h_prev != nullptr && b < B) {
      h = *reinterpret_cast<const float4*>(
          h_prev + static_cast<size_t>(b) * H + c);
    }
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(As + row * lda + c);
    dst[0] = __floats2bfloat162_rn(h.x, h.y);
    dst[1] = __floats2bfloat162_rn(h.z, h.w);
  }
  // U_h columns j0.., H+j0.., 2H+j0.. of every row: six 16-byte loads a row.
  for (int i = tid; i < H * 6; i += kThreads) {
    const int k = i / 6;
    const int s = i - k * 6;
    const int g = s >> 1;
    const int half = (s & 1) * 8;
    *reinterpret_cast<uint4*>(Bs + k * kBLd + g * kTile + half) =
        *reinterpret_cast<const uint4*>(uh + k * H3 + g * H + j0 + half);
  }
  __syncthreads();

  const int warp = tid >> 5;
  if (warp < 3) {  // warp g computes gate g's 16x16 tile of gh
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < H; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
      wmma::load_matrix_sync(af, As + kk, lda);
      wmma::load_matrix_sync(bf, Bs + kk * kBLd + warp * kTile, kBLd);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Cs + warp * kTile, acc, kCLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const int bl = tid / kTile;
  const int jl = tid - bl * kTile;
  const int b = b0 + bl;
  const int j = j0 + jl;
  if (b >= B) return;
  const float* gh = Cs + bl * kCLd + jl;
  const float* g = gx + b * H3;
  const float r = sigmoid(g[j] + gh[0]);
  const float z = sigmoid(g[H + j] + gh[kTile]);
  const float n = tanhf(g[2 * H + j] + r * (gh[2 * kTile] + bhn[j]));
  const size_t o = static_cast<size_t>(b) * H + j;
  const float hp = h_prev != nullptr ? h_prev[o] : 0.0f;
  const float h_new = (1.0f - z) * n + z * hp;
  const float h = t < lens[b] ? h_new : hp;
  h_out[o] = h;
  if (h_final != nullptr) h_final[o] = h;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// gx_t [T, B, 3H] f32, lens [B] i32, uh [H, 3H] bf16, bhn [H] f32
// -> hseq [T, B, H] f32 (post-step state of actual timestep t), hT [B, H].
// Needs H % 16 == 0 (checked by the caller). Launches T step kernels on
// `stream`, counting in *launched those that launched; returns the first
// error.
int gru_fwd(const void* gx_t, const void* lens, const void* uh,
            const void* bhn, void* hseq, void* hT, int T, int B, int H,
            int reverse, void* stream, int* launched) {
  *launched = 0;
  const size_t smem = smem_bytes(H);
  cudaError_t e = cudaFuncSetAttribute(
      gru_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(H / kTile, (B + kTile - 1) / kTile);
  const size_t step_gx = static_cast<size_t>(B) * 3 * H;
  const size_t step_h = static_cast<size_t>(B) * H;
  const float* h_prev = nullptr;
  for (int k = 0; k < T; ++k) {
    const int t = reverse ? T - 1 - k : k;
    float* h_out = static_cast<float*>(hseq) + t * step_h;
    gru_step_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(gx_t) + t * step_gx, h_prev,
        static_cast<const __nv_bfloat16*>(uh),
        static_cast<const float*>(bhn), static_cast<const int*>(lens), h_out,
        k == T - 1 ? static_cast<float*>(hT) : nullptr, B, H, t);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launched;
    h_prev = h_out;
  }
  return 0;
}

}  // extern "C"
