// K5 `attention_resident_bwd`: backward of the gather-free attention (K4)
// with G glimpses (1 <= G <= 8) from its saved h, for Hopper (sm_90a). The
// same source builds K5h (csrc/attention_resident_bwd_f16.cu), the float16
// instance: E = KernelElem (elem16.cuh), the Pallas body's compute dtype
// dt, is bf16 here and float16 there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_bwd_kernel_multi (the Pallas body launched by _resident_bwd_multi).
// For question b with v = store[rows[b]], the saved post-ReLU h (shared by
// the glimpses) and, per glimpse g, alpha_g, the v_att_g cotangent g_g and
// sga_g = g_alpha_g - S_g (packed by the caller):
//
//   dalpha_gn = (E(g_g) . v_n) * r_n              (r = 1 when !normalize)
//   ds_gn     = alpha_gn (dalpha_gn + sga_gn)
//   dz_nk     = sum_g [h_nk > 0] ds_gn ws_gk      (f32, glimpses in order)
//   dqh_bk    = sum_n dz_nk,   dws_gk += sum_n ds_gn h_nk
//   dW_v      = sum_{b,n} v_n^T E(dz_n r_n)       (once, on the summed dz)
//
// The store gets no gradient (it is data). The rounding points are the
// Pallas kernel's: g and dz * r in E, every sum in f32, and dalpha * r and
// the sum with sga each rounded on its own (two f32 operations, as JAX
// rounds them, never one fused multiply-add).
//
// The store rows are E, or the int8 codes of an L2-prenormalized store
// (the Pallas kernel's int8 branch, which widens the codes to h's dtype):
// both stages widen the codes to E as they load them, exactly
// (store_rows.cuh), and the rest runs as on E rows. The store's scale is
// applied outside (to g before, to dW_v after), and an int8 store is never
// normalized here.
//
// What bounds it on an H100: dW_v over the B * n_valid = 50176 live cells
// of a batch of 256 is 105 GFLOP of bf16 (106 us at 989 TFLOP/s) whatever
// G is; the bytes (205 MB of grid or 102 MB of int8 codes, 51 MB of h) take
// 77 us at most: the tensor cores.
//
// Design: the TPU kernel runs the questions on a sequential grid and
// accumulates dW_v and dws in resident output blocks. Hopper blocks run in
// parallel with nothing carried between them, and float atomics would make
// the sums depend on the schedule, so the work is split in three launches:
//
//  1. attn_res_bwd_rows_kernel, the per-question pass on attention_rows.cuh:
//     one block a question stages the G cotangent rows in E (G * C * 2
//     bytes: 32 KB at G=8, C=2048) and its cells' alpha; each warp takes
//     cells and reads each store row ONCE, a whole row's 16-byte loads in
//     flight, for all G dalphas (and the sum of squares when normalizing);
//     then each thread takes 8 hidden units of 4 cells at a time (16-byte
//     loads of h and stores of E(dz * r) of the summed dz, written
//     compactly as [B * n_valid, H]) and keeps its units' dqh and G dws
//     partials in registers, summed over the threads that share its units
//     in a fixed xor tree inside their warp. No atomics.
//  2. the dW_v GEMM, [C, B*n_valid] x [B*n_valid, H], with the store rows
//     looked up per cell as in K4 (attention_dwv.cuh, shared with K8 and
//     P2): wgmma on transposed operands from a cp.async ring, blocks own
//     128 x 256 tiles of dW_v (128 x 128 where 256 does not divide H) and
//     a fixed slice of the cells (split over K so that the grid is one wave
//     of the card), one partial tile per block. It runs once for all
//     glimpses, as on the TPU.
//  3. a reduction that sums the dW_v partials over the splits and the dws
//     partials over the questions, both in a fixed order: the result does
//     not depend on the schedule.
//
// G is a template parameter instantiated for 1..8, so the G=1 code is the
// single-glimpse kernel; the row type T (E or int8) is the second,
// picked by a flag in the C entry, and the rows kernel on E rows takes
// normalize as a third (no squares are summed where they are not used), and
// E the fourth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_dwv.cuh"
#include "attention_rows.cuh"

namespace {

constexpr int kRowThreads = attn_rows::kThreads;
constexpr int kUnits = attn_rows::kUnits;
constexpr int kDefaultSmem = 48 * 1024;  // above it: opt in per kernel

template <int G, class T, bool kNorm, class E>
__global__ void __launch_bounds__(kRowThreads)
attn_res_bwd_rows_kernel(const T* __restrict__ store,  // [M, Np, C]
                         const int* __restrict__ rows,         // [B]
                         const E* __restrict__ h,              // [B, Np, H]
                         const float* __restrict__ ws,         // [G, H]
                         const float* __restrict__ alpha,      // [B, Np, G]
                         const float* __restrict__ g,          // [B, G, C]
                         const float* __restrict__ sga,        // [B, Np, G]
                         float* __restrict__ dqh,              // [B, H]
                         float* __restrict__ dws_part,         // [B, G, H]
                         E* __restrict__ dzr,          // [B*n_valid, H]
                         int Np, int n_valid, int C, int H) {
  // E(g) [G][C], then alpha -> ds [n_valid][G] and r [n_valid] in f32
  // (G * C * 2 bytes is a multiple of 16: C % 128 == 0).
  extern __shared__ __align__(16) unsigned char smem[];
  E* gs = reinterpret_cast<E*>(smem);
  float* ds = reinterpret_cast<float*>(smem + sizeof(E) * G * C);
  float* rs = ds + n_valid * G;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* gb = g + static_cast<size_t>(b) * G * C;
  for (int i = tid; i < G * C; i += kRowThreads) {
    gs[i] = Elem<E>::from(gb[i]);
  }
  const size_t o0 = static_cast<size_t>(b) * Np * G;
  for (int i = tid; i < n_valid * G; i += kRowThreads) ds[i] = alpha[o0 + i];
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const T* v = store + static_cast<size_t>(rows[b]) * Np * C;
  for (int n = warp; n < n_valid; n += attn_rows::kWarps) {
    float dot[G], sq;
    attn_rows::cell_dots<G, kNorm>(v + static_cast<size_t>(n) * C, gs, C,
                                   lane, dot, sq);
    if (lane == 0) {
      const float r = kNorm ? rsqrtf(sq + 1e-12f) : 1.0f;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        const int i = n * G + k;
        // dalpha * r, then + sga, each rounded (JAX's two operations).
        ds[i] = ds[i] * __fadd_rn(__fmul_rn(dot[k], r), sga[o0 + i]);
      }
      rs[n] = r;
    }
  }
  __syncthreads();

  // Thread (lu, cl) takes units 8 lu .. 8 lu + 7 of a pass of W units and
  // the cells cl, cl + P, ...; the P threads of a group are neighbours in
  // one warp.
  const int P = attn_rows::cell_lanes(H);
  const int W = attn_rows::unit_lanes(H) * kUnits;
  const int cl = tid % P, lu = tid / P;
  const E* hb = h + static_cast<size_t>(b) * Np * H;
  E* ob = dzr + static_cast<size_t>(b) * n_valid * H;
  for (int u_base = 0; u_base < H; u_base += W) {
    const int u0 = u_base + lu * kUnits;
    const bool active = lu * kUnits < W && u0 < H;
    float wk[G][kUnits], dw[G][kUnits], dq[kUnits];
#pragma unroll
    for (int j = 0; j < G; ++j) {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        wk[j][i] = active ? ws[static_cast<size_t>(j) * H + u0 + i] : 0.0f;
        dw[j][i] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnits; ++i) dq[i] = 0.0f;
    if (active) {
      for (int nb = cl; nb < n_valid; nb += P * attn_rows::kCellsInFlight) {
        uint4 hx[attn_rows::kCellsInFlight];
#pragma unroll
        for (int f = 0; f < attn_rows::kCellsInFlight; ++f) {
          const int n = nb + f * P;
          if (n < n_valid) {
            hx[f] = *reinterpret_cast<const uint4*>(
                hb + static_cast<size_t>(n) * H + u0);
          }
        }
#pragma unroll
        for (int f = 0; f < attn_rows::kCellsInFlight; ++f) {
          const int n = nb + f * P;
          if (n < n_valid) {
            const E* he = reinterpret_cast<const E*>(&hx[f]);
            float d[G];
#pragma unroll
            for (int j = 0; j < G; ++j) d[j] = ds[n * G + j];
            const float r = rs[n];
            uint4 out;
            E* oe = reinterpret_cast<E*>(&out);
#pragma unroll
            for (int i = 0; i < kUnits; ++i) {
              const float hv = Elem<E>::to(he[i]);
              float dz = 0.0f;
#pragma unroll
              for (int j = 0; j < G; ++j) {
                // The product rounded on its own, as the reference's
                // where(...).
                if (hv > 0.0f) dz += __fmul_rn(d[j], wk[j][i]);
                dw[j][i] = fmaf(d[j], hv, dw[j][i]);
              }
              dq[i] += dz;
              oe[i] = Elem<E>::from(dz * r);
            }
            *reinterpret_cast<uint4*>(ob + static_cast<size_t>(n) * H + u0) =
                out;
          }
        }
      }
    }
    // The question's sums over its cells: the group's P partials meet in
    // a fixed xor tree, and its first thread writes dqh and dws_part.
    for (int o = P / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < kUnits; ++i) {
        dq[i] += __shfl_xor_sync(0xffffffffu, dq[i], o);
#pragma unroll
        for (int j = 0; j < G; ++j) {
          dw[j][i] += __shfl_xor_sync(0xffffffffu, dw[j][i], o);
        }
      }
    }
    if (active && cl == 0) {
      auto put = [&](float* dst, const float (&x)[kUnits]) {
        float4* d4 = reinterpret_cast<float4*>(dst + u0);
        d4[0] = make_float4(x[0], x[1], x[2], x[3]);
        d4[1] = make_float4(x[4], x[5], x[6], x[7]);
      };
      put(dqh + static_cast<size_t>(b) * H, dq);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        put(dws_part + (static_cast<size_t>(b) * G + j) * H, dw[j]);
      }
    }
  }
}

template <int G, class T, bool kNorm, class E>
cudaError_t launch_rows(const void* store, const void* rows, const void* h,
                        const void* ws, const void* alpha, const void* g,
                        const void* sga, void* dqh, void* dws_part, void* dzr,
                        int B, int Np, int n_valid, int C, int H,
                        cudaStream_t st) {
  const attn_rows::Shape s = attn_rows::plan(B, n_valid, G, C, H);
  auto kernel = attn_res_bwd_rows_kernel<G, T, kNorm, E>;
  if (s.smem_bytes > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem_bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return e;
    }
  }
  kernel<<<s.grid_x, s.threads, s.smem_bytes, st>>>(
      static_cast<const T*>(store), static_cast<const int*>(rows),
      static_cast<const E*>(h), static_cast<const float*>(ws),
      static_cast<const float*>(alpha), static_cast<const float*>(g),
      static_cast<const float*>(sga), static_cast<float*>(dqh),
      static_cast<float*>(dws_part), static_cast<E*>(dzr), Np, n_valid, C,
      H);
  return cudaGetLastError();
}

template <int G, class T, class E>
int launch_bwd(const void* store, const void* rows, const void* h,
               const void* ws, const void* alpha, const void* g,
               const void* sga, void* dzr, void* dws_part, void* part,
               void* dqh, void* dwv, void* dws, int B, int Np, int n_valid,
               int C, int H, int normalize, int splits, cudaStream_t st,
               int* launched) {
  // An int8 store is never normalized here: no kernel of codes that sums
  // squares.
  const bool norm = !store_rows::kInt8<T> && normalize;
  cudaError_t e =
      norm ? launch_rows<G, T, !store_rows::kInt8<T>, E>(
                 store, rows, h, ws, alpha, g, sga, dqh, dws_part, dzr, B, Np,
                 n_valid, C, H, st)
           : launch_rows<G, T, false, E>(store, rows, h, ws, alpha, g, sga,
                                         dqh, dws_part, dzr, B, Np, n_valid, C,
                                         H, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_dwv(
      attn_dwv::StoreCells<T>{static_cast<const T*>(store),
                              static_cast<const int*>(rows), n_valid, Np, C},
      static_cast<const E*>(dzr), static_cast<float*>(part), B * n_valid, C,
      H, splits, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  e = attn_dwv::launch_reduce(static_cast<const float*>(part),
                              static_cast<const float*>(dws_part),
                              static_cast<float*>(dwv),
                              static_cast<float*>(dws), splits, C, H, B,
                              G * H, st);
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dW_v launch's shape over K cells split `splits` ways at C x H on
// E rows or int8 codes: tile (channels x units), ring stages, dynamic
// shared memory in bytes, chunks of 64 cells a split and grid (unit tiles,
// channel tiles, splits).
int attention_resident_bwd_dwv_config(int K, int C, int H, int int8,
                                      int splits, int* out) {
  const attn_dwv::Shape s =
      attn_dwv::plan<KernelElem>(K, C, H, int8 != 0, splits);
  const int v[8] = {s.tile_m, s.tile_n, s.stages, s.smem_bytes,
                    s.chunks_per_split, s.grid_x, s.grid_y, s.grid_z};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// The rows launch's shape: grid, threads, dynamic shared memory in bytes,
// cell lanes and unit passes.
int attention_resident_bwd_rows_config(int B, int n_valid, int G, int C,
                                       int H, int* out) {
  const attn_rows::Shape s = attn_rows::plan(B, n_valid, G, C, H);
  const int v[5] = {s.grid_x, s.threads, s.smem_bytes, s.cell_lanes,
                    s.unit_passes};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// store [M, Np, C] of E, or int8 codes when int8 != 0 (then normalize must
// be 0), rows [B] i32, h [B, Np, H] E (K4's residual, 16-byte aligned),
// ws [G, H] f32 (1 <= G <= 8), alpha [B, Np, G] f32, g [B, G, C] f32, sga
// [B, Np, G] f32 -> dqh [B, H], dwv [C, H], dws [G, H], all f32. Scratch:
// dzr [B*n_valid, H] E, dws_part [B, G, H] f32, part [splits, C, H] f32.
// Needs C % 128 == 0 and H % 128 == 0 and the rows launch's shared memory
// (attn_rows::plan) at most 227 KB (checked by the caller). Three launches
// on `stream`, counting in *launched those that launched; returns the first
// launch error.
int attention_resident_bwd(const void* store, const void* rows,
                           const void* h, const void* ws, const void* alpha,
                           const void* g, const void* sga, void* dzr,
                           void* dws_part, void* part, void* dqh, void* dwv,
                           void* dws, int B, int Np, int n_valid, int C,
                           int H, int G, int normalize, int int8, int splits,
                           void* stream, int* launched) {
  *launched = 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8 && normalize) return static_cast<int>(cudaErrorInvalidValue);
  using E = KernelElem;
#define K5_CASE(k)                                                            \
  case k:                                                                     \
    return int8 ? launch_bwd<k, int8_t, E>(store, rows, h, ws, alpha, g, sga, \
                                           dzr, dws_part, part, dqh, dwv,     \
                                           dws, B, Np, n_valid, C, H, 0,      \
                                           splits, st, launched)              \
                : launch_bwd<k, E, E>(store, rows, h, ws, alpha, g, sga, dzr, \
                                      dws_part, part, dqh, dwv, dws, B, Np,   \
                                      n_valid, C, H, normalize, splits, st,   \
                                      launched);
  switch (G) {
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4)
    K5_CASE(5) K5_CASE(6) K5_CASE(7) K5_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_CASE
}

}  // extern "C"
