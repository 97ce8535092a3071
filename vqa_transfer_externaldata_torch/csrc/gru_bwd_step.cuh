// The kernels of the GRU's backpropagation through time, shared by K3
// `gru_bwd` (csrc/gru_bwd.cu, one direction) and K7 `bigru_bwd`
// (csrc/bigru_bwd.cu, both directions of a bidirectional GRU in each
// launch). The step math is vqa_transfer_externaldata_tpu/ops/gru.py::
// _gru_cell_bwd. Walking the processing order backwards, with dh the
// cotangent of the state after step t and h_prev the state before it:
//
//   gh   = bf16(h_prev) @ U_h                     (recomputed, f32 sums)
//   r, z, n as in the forward;  m = t < lens[b]
//   dh_new = m dh;  dz = dh_new (h_prev - n);  dn = dh_new (1 - z)
//   da_n = dn (1 - n^2);  dgh_n = da_n r;  da_r = da_n (gh_n + b_hn) r (1-r)
//   da_z = dz z (1 - z)
//   dgx[t] = [da_r, da_z, da_n]
//   dh_prev = (1 - m) dh + dh_new z + bf16([da_r, da_z, dgh_n]) @ U_h^T
//   dU_h  += bf16(h_prev)^T @ bf16([da_r, da_z, dgh_n]),  db_hn += sum_b dgh_n
//
// The bf16 rounding points are JAX's: h_prev before U_h and before dU_h,
// the gate cotangents before U_h^T and dU_h.
//
//  1. gru_bwd_step_kernel, one launch per timestep. A block owns a 16-row x
//     16-unit tile (b, j) of the state. It first finishes dh for its tile
//     from the previous launch: the elementwise part that launch left in
//     `dhe`, plus its 16 rows of the bf16 gate cotangents G times rows
//     j0..j0+15 of U_h (three warps, one gate chunk each, summed in JAX's
//     order). It recomputes gh for its 48 gate columns from bf16(h_prev)
//     on three more warps (bf16 WMMA 16x16x16, f32 accumulation), then each
//     thread takes one (b, j): writes dgx, G and the next elementwise part,
//     and the block sums dgh_n over its 16 rows into a per-step partial.
//  2. gru_duh_kernel, one launch after the sequence: the GEMM
//     dU_h = sum_t bf16(h_prev_t)^T G_t, contracting K = (T-1) * B rows.
//     h_prev_t is hseq shifted by one step (the first processed step has
//     h_prev = 0 and adds nothing), so A and B are plain offset views of
//     hseq (rounded to bf16 as it is staged) and G. Each 64 x 64 output
//     tile is one block's own sum: deterministic, no atomics.
//  3. gru_dbhn_kernel: db_hn as a fixed-order sum of the per-step partials.
//
// Each kernel takes the arguments of one or two independent recurrences
// (`d0`, `d1`) and picks its direction from a grid axis, so one launch
// serves both directions of a bidirectional GRU with the same arithmetic as
// two one-direction launches.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kTile = 16;          // batch rows and hidden units per block
constexpr int kCols = 3 * kTile;   // U_h columns per block (r, z, n)
constexpr int kThreads = 256;      // one per element of the state tile
constexpr int kBLd = kCols + 8;    // padded leading dims of the smem tiles
constexpr int kCLd = kCols + 4;
constexpr int kPLd = kTile + 4;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}
__host__ __device__ constexpr int a_ld(int H) { return H + 8; }
__host__ __device__ constexpr int g_ld(int H) { return 3 * H + 8; }

// As [16][H+8] bf16 | Bs [H][56] bf16 | Gs [16][3H+8] bf16 |
// Us [16][3H+8] bf16 | Cs [16][52] f32 | Ps [3][16][20] f32 | Rs [16][16] f32
__host__ __device__ constexpr size_t off_bs(int H) {
  return align128(static_cast<size_t>(kTile) * a_ld(H) * 2);
}
__host__ __device__ constexpr size_t off_gs(int H) {
  return off_bs(H) + align128(static_cast<size_t>(H) * kBLd * 2);
}
__host__ __device__ constexpr size_t off_us(int H) {
  return off_gs(H) + align128(static_cast<size_t>(kTile) * g_ld(H) * 2);
}
__host__ __device__ constexpr size_t off_cs(int H) {
  return off_us(H) + align128(static_cast<size_t>(kTile) * g_ld(H) * 2);
}
__host__ __device__ constexpr size_t off_ps(int H) {
  return off_cs(H) + align128(static_cast<size_t>(kTile) * kCLd * 4);
}
__host__ __device__ constexpr size_t off_rs(int H) {
  return off_ps(H) + align128(3 * static_cast<size_t>(kTile) * kPLd * 4);
}
__host__ __device__ constexpr size_t step_smem_bytes(int H) {
  return off_rs(H) + static_cast<size_t>(kTile) * kTile * 4;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One direction's BPTT step. h_prev == nullptr: the zero initial state (the
// first processed step). g_prev == nullptr: the first BPTT step, whose dh
// is `dhe` as given (the cotangent of the final state).
struct BwdStep {
  const float* gx;               // [B, 3H] at t
  const float* h_prev;           // [B, H] or null
  const __nv_bfloat16* uh;       // [H, 3H]
  const float* bhn;              // [H]
  const __nv_bfloat16* g_prev;   // [B, 3H] or null
  float* dhe;                    // [B, H] in/out
  float* dgx;                    // [B, 3H] at t
  __nv_bfloat16* g_out;          // [B, 3H] at t
  float* part;                   // [B/16, H]
  int t;
};

__global__ void __launch_bounds__(kThreads)
gru_bwd_step_kernel(BwdStep d0, BwdStep d1, const int* __restrict__ lens,
                    int B, int H) {
  const BwdStep s = blockIdx.z == 0 ? d0 : d1;
  const float* __restrict__ h_prev = s.h_prev;
  const __nv_bfloat16* __restrict__ uh = s.uh;
  const __nv_bfloat16* __restrict__ g_prev = s.g_prev;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = a_ld(H);
  const int ldg = g_ld(H);
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + off_bs(H));
  __nv_bfloat16* Gs = reinterpret_cast<__nv_bfloat16*>(smem + off_gs(H));
  __nv_bfloat16* Us = reinterpret_cast<__nv_bfloat16*>(smem + off_us(H));
  float* Cs = reinterpret_cast<float*>(smem + off_cs(H));
  float* Ps = reinterpret_cast<float*>(smem + off_ps(H));
  float* Rs = reinterpret_cast<float*>(smem + off_rs(H));

  const int tid = threadIdx.x;
  const int b0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const size_t H3 = 3 * static_cast<size_t>(H);

  // bf16(h_prev) rows b0..b0+15, four floats per load.
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
    const int sl = i - k * 6;
    const int g = sl >> 1;
    const int half = (sl & 1) * 8;
    *reinterpret_cast<uint4*>(Bs + k * kBLd + g * kTile + half) =
        *reinterpret_cast<const uint4*>(uh + k * H3 + g * H + j0 + half);
  }
  if (g_prev != nullptr) {
    // G_prev rows b0..b0+15 and U_h rows j0..j0+15, all 3H columns.
    const int v8 = static_cast<int>(H3 / 8);
    for (int i = tid; i < kTile * v8; i += kThreads) {
      const int row = i / v8;
      const int c = (i - row * v8) * 8;
      const int b = b0 + row;
      uint4 gv = make_uint4(0u, 0u, 0u, 0u);
      if (b < B) {
        gv = *reinterpret_cast<const uint4*>(g_prev + b * H3 + c);
      }
      *reinterpret_cast<uint4*>(Gs + row * ldg + c) = gv;
      *reinterpret_cast<uint4*>(Us + row * ldg + c) =
          *reinterpret_cast<const uint4*>(uh + (j0 + row) * H3 + c);
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  if (warp < 3) {  // warp g: gate g's 16x16 tile of gh = bf16(h_prev) U_h
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
  } else if (warp < 6 && g_prev != nullptr) {
    // warp 3+g: gate chunk g of G_prev U_h^T for the tile; U_h rows are
    // the columns of U_h^T, so they load as a column-major B operand.
    const int g = warp - 3;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = g * H; kk < (g + 1) * H; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf;
      wmma::load_matrix_sync(af, Gs + kk, ldg);
      wmma::load_matrix_sync(bf, Us + kk, ldg);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Ps + g * kTile * kPLd, acc, kPLd,
                            wmma::mem_row_major);
  }
  __syncthreads();

  const int bl = tid / kTile;
  const int jl = tid - bl * kTile;
  const int b = b0 + bl;
  const int j = j0 + jl;
  float dgh_n = 0.0f;
  if (b < B) {
    const size_t o = static_cast<size_t>(b) * H + j;
    float dh = s.dhe[o];
    if (g_prev != nullptr) {
      const int p = bl * kPLd + jl;
      dh = ((dh + Ps[p]) + Ps[kTile * kPLd + p]) + Ps[2 * kTile * kPLd + p];
    }
    const float* gh = Cs + bl * kCLd + jl;
    const float* g = s.gx + b * H3;
    const float ghn_b = gh[2 * kTile] + s.bhn[j];
    const float r = sigmoid(g[j] + gh[0]);
    const float z = sigmoid(g[H + j] + gh[kTile]);
    const float n = tanhf(g[2 * H + j] + r * ghn_b);
    const float hp = h_prev != nullptr ? h_prev[o] : 0.0f;
    const float m = s.t < lens[b] ? 1.0f : 0.0f;
    const float dh_new = m * dh;
    const float dhp = (1.0f - m) * dh + dh_new * z;
    const float dz = dh_new * (hp - n);
    const float dn = dh_new * (1.0f - z);
    const float da_n = dn * (1.0f - n * n);
    const float dr = da_n * ghn_b;
    dgh_n = da_n * r;
    const float da_r = dr * r * (1.0f - r);
    const float da_z = dz * z * (1.0f - z);
    float* dg = s.dgx + b * H3;
    dg[j] = da_r;
    dg[H + j] = da_z;
    dg[2 * H + j] = da_n;
    __nv_bfloat16* go = s.g_out + b * H3;
    go[j] = __float2bfloat16(da_r);
    go[H + j] = __float2bfloat16(da_z);
    go[2 * H + j] = __float2bfloat16(dgh_n);
    s.dhe[o] = dhp;
  }
  Rs[bl * kTile + jl] = dgh_n;
  __syncthreads();
  if (tid < kTile) {
    float sum = 0.0f;
    for (int i = 0; i < kTile; ++i) sum += Rs[i * kTile + tid];
    s.part[static_cast<size_t>(blockIdx.y) * H + j0 + tid] = sum;
  }
}

constexpr int kGM = 64;   // dU_h rows (hidden units i) per block
constexpr int kGN = 64;   // dU_h columns (gate outputs) per block
constexpr int kGK = 32;   // rows of K per stage
constexpr int kGLd = kGM + 8;
constexpr int kGThreads = 128;  // 4 warps, 2 x 2 of 32 x 32

// One direction's dU_h [H, 3H] = sum_k bf16(hp[k, :])^T g[k, :], K rows.
struct DuhGemm {
  const float* hp;             // [K, H] f32
  const __nv_bfloat16* g;      // [K, 3H] bf16
  float* duh;                  // [H, 3H]
};

__global__ void __launch_bounds__(kGThreads)
gru_duh_kernel(DuhGemm d0, DuhGemm d1, int K, int H) {
  const DuhGemm s = blockIdx.z == 0 ? d0 : d1;
  const float* __restrict__ hp = s.hp;
  const __nv_bfloat16* __restrict__ g = s.g;
  __shared__ __align__(128) __nv_bfloat16 As[kGK * kGLd];  // [k][i]
  __shared__ __align__(128) __nv_bfloat16 Bs[kGK * kGLd];  // [k][n]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wr = warp >> 1;
  const int wc = warp & 1;
  const int i0 = blockIdx.y * kGM;
  const int n0 = blockIdx.x * kGN;
  const int H3 = 3 * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) wmma::fill_fragment(acc[a][c], 0.0f);

  for (int k0 = 0; k0 < K; k0 += kGK) {
    // A: 32 rows x 64 floats = 512 float4, four per thread.
    for (int i = tid; i < kGK * kGM / 4; i += kGThreads) {
      const int r = i / (kGM / 4);
      const int c = (i % (kGM / 4)) * 4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + r < K) {
        x = *reinterpret_cast<const float4*>(
            hp + static_cast<size_t>(k0 + r) * H + i0 + c);
      }
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          As + r * kGLd + c);
      dst[0] = __floats2bfloat162_rn(x.x, x.y);
      dst[1] = __floats2bfloat162_rn(x.z, x.w);
    }
    // B: 32 rows x 64 bf16 = 256 x 16 bytes, two per thread.
    for (int i = tid; i < kGK * kGN / 8; i += kGThreads) {
      const int r = i / (kGN / 8);
      const int c = (i % (kGN / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < K) {
        x = *reinterpret_cast<const uint4*>(
            g + static_cast<size_t>(k0 + r) * H3 + n0 + c);
      }
      *reinterpret_cast<uint4*>(Bs + r * kGLd + c) = x;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        wmma::load_matrix_sync(af[a], As + kk * kGLd + wr * 32 + a * 16,
                               kGLd);
        wmma::load_matrix_sync(bf[a], Bs + kk * kGLd + wc * 32 + a * 16,
                               kGLd);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          wmma::mma_sync(acc[a][c], af[a], bf[c], acc[a][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      wmma::store_matrix_sync(
          s.duh + static_cast<size_t>(i0 + wr * 32 + a * 16) * H3 + n0 +
              wc * 32 + c * 16,
          acc[a][c], H3, wmma::mem_row_major);
}

// One direction's db_hn[j] = sum over its n_part per-step partials, in a
// fixed order. blockIdx.y picks the direction.
struct DbhnSum {
  const float* part;           // [n_part, H]
  float* dbhn;                 // [H]
};

__global__ void gru_dbhn_kernel(DbhnSum d0, DbhnSum d1, int n_part, int H) {
  const DbhnSum s = blockIdx.y == 0 ? d0 : d1;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= H) return;
  float sum = 0.0f;
  for (int p = 0; p < n_part; ++p) {
    sum += s.part[static_cast<size_t>(p) * H + j];
  }
  s.dbhn[j] = sum;
}

// Grants the step kernel its dynamic shared memory; returns the CUDA error.
inline cudaError_t prepare_bwd_step_kernel(int H) {
  return cudaFuncSetAttribute(gru_bwd_step_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(step_smem_bytes(H)));
}

}  // namespace
