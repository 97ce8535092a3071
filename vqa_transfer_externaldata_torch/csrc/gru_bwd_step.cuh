// The backpropagation through time of the GRU recurrence for Hopper
// (sm_90a): the kernels and their launch, shared by K3 `gru_bwd`
// (csrc/gru_bwd.cu, one recurrence) and K7 `bigru_bwd` (csrc/bigru_bwd.cu,
// both recurrences of a bidirectional GRU in the same launches). The step
// math is vqa_transfer_externaldata_tpu/ops/gru.py::_gru_cell_bwd. Walking
// the processing order backwards, with dh the cotangent of the state after
// step t and h_prev the state before it:
//
//   gh   = E(h_prev) @ U_h                        (recomputed, f32 sums)
//   r, z, n as in the forward;  m = t < lens[b]
//   dh_new = m dh;  dz = dh_new (h_prev - n);  dn = dh_new (1 - z)
//   da_n = dn (1 - n^2);  dgh_n = da_n r;  da_r = da_n (gh_n + b_hn) r (1-r)
//   da_z = dz z (1 - z)
//   dgx[t] = [da_r, da_z, da_n]
//   dh_prev = (1 - m) dh + dh_new z + E([da_r, da_z, dgh_n]) @ U_h^T
//   dU_h  += E(h_prev)^T @ E([da_r, da_z, dgh_n]),  db_hn += sum_b dgh_n
//
// E is U_h's 16-bit type, bf16 (K3, K7) or float16 (K3h), and the rounding
// points are JAX's: h_prev before U_h and before dU_h, the gate cotangents
// before U_h^T and dU_h (its da_*.astype(uht_ref.dtype)). A float16
// cotangent below f16's smallest subnormal rounds to 0 there, as in JAX.
//
// The TPU kernel walks a sequential grid of T steps with dh in VMEM and
// dU_h in a resident output block. Here:
//
//  1. gru_bptt_kernel, ONE cooperative launch for all T steps of every
//     direction. Block (jt, bb, d) owns the 16 hidden units j0 = 16 jt.. of
//     direction d for the whole call and keeps two slices of that
//     direction's U_h in shared memory throughout: its 48 columns
//     {j0, H+j0, 2H+j0} + 0..15 (the B operand of gh) and its rows
//     j0..j0+15 (the B operand of the U_h^T product). The blocks of a
//     direction first write the E copy of its pre-step states that the
//     steps and the dU_h GEMM read, striding over it together; then every
//     block walks the steps, separated by grid-wide barriers, and within a
//     step its 64-row b-tiles (bb, bb + gridDim.y, ...). A b-tile streams
//     E(h_prev) and the previous step's E gate cotangents G_prev
//     through a 3-stage ring of cp.async copies, 64 columns of each gate a
//     stage; warp pair rb (16 rows) splits into a warp that accumulates gh
//     for the 3 gates and one that accumulates the 3 gate chunks of
//     G_prev U_h^T. The elementwise BPTT, its operands loaded into
//     registers ahead of the mainloop, then writes dgx, G_t, the carried dh
//     (`dhe`, read and written by the same thread) and the per-16-row dgh_n
//     partials. G_t is the only state that blocks exchange.
//  2. gru_duh_pipe_kernel: each direction's dU_h = sum_t E(h_prev_t)^T
//     G_t over the (T-1) B rows of its sequence, 128 x 64 tiles, 8 warps of
//     32 x 32, a 4-stage cp.async ring of 128-row K slices of the E copy
//     and of G (both k-major, so their fragments load through ldmatrix's
//     transpose).
//  3. gru_dbhn_kernel: each direction's db_hn as a fixed-order sum of its
//     per-step partials.
//
// The copy, ldmatrix and mma.sync primitives are mma_sync.cuh's, which K1's
// persistent kernel (gru_fwd.cu) runs too: every 16x16 fragment of gh, of
// each U_h^T chunk and of dU_h is one chain of 16x16x16 E products (two
// HMMA.16816 each) in ascending 16-steps of k, dh is
// ((dhe + P0) + P1) + P2, and db_hn sums the partials in step order.
//
// Each kernel takes the arguments of two recurrences (p0/p1, d0/d1) and
// picks its own with a grid axis (blockIdx.z; blockIdx.y for db_hn): K3
// launches one direction, K7 two. A block's work depends only on its own
// direction's arguments and on the b-tiles it walks, never on how many rows
// of blocks share them, so each direction of a K7 launch gives the bits of
// a K3 launch with the same `reverse`. Step k of one chain never reads the
// other chain's results, so both chains share one barrier a step. No
// atomics: the result is deterministic.
//
// The launch: ops/kernels.py::gru_bwd_plan picks the rows of blocks from
// the blocks resident per SM that bptt_occupancy reports (H / 16 j-tiles
// for each direction, times as many rows as are resident beside each other,
// at most one per b-tile), and bptt_run derives the grid from those rows.
// U_h's slices and the ring take 215 KB a block at H = 512, one block an
// SM; they fit up to H = 576 on an H100 (about 208 H + 104 KB: 317 KB at
// H = 1024, past a block's 227 KB), and bptt_occupancy reports the widest
// H that fits on the card. Wider, ops/kernels.py::gru_bwd_route sends the
// wrappers to the step form of gru_wide_step.cuh (two launches a step),
// which ends in this header's dU_h GEMM and db_hn sum.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"  // and elem16.cuh

namespace {

constexpr int kTile = 16;          // units of a block, rows of a partial
constexpr int kCols = 3 * kTile;   // U_h columns per block (r, z, n)
constexpr int kThreads = 256;      // threads of a block
constexpr int kBLd = kCols + 8;    // padded leading dims of the smem tiles
constexpr int kCLd = kCols + 4;
constexpr int kPLd = kTile + 4;

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}
__host__ __device__ constexpr int g_ld(int H) { return 3 * H + 8; }

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

namespace cgrp = cooperative_groups;

constexpr int kRows = 64;            // batch rows of a b-tile
constexpr int kKc = 64;              // columns of each gate in a ring stage
constexpr int kStages = 3;           // depth of the step's cp.async ring
constexpr int kHLd = kKc + 8;        // h_prev stage [64][72] E
constexpr int kGsLd = 3 * kKc + 8;   // G_prev stage [64][200] E
constexpr size_t kStageBytes =
    static_cast<size_t>(kRows) * (kHLd + kGsLd) * 2;
constexpr size_t kCsBytes = static_cast<size_t>(kRows) * kCLd * 4;
constexpr size_t kPsBytes = 3 * static_cast<size_t>(kRows) * kPLd * 4;
static_assert(kCsBytes + kPsBytes <= kStages * kStageBytes,
              "gh and the U_h^T chunks reuse the ring after the mainloop");
static_assert(kRows * kKc / 8 % kThreads == 0, "whole copies a thread");

// Uc [H][56] E | Ur [16][3H+8] E | ring [3][64][72 + 200] E (E: 2 bytes),
// which after a tile's mainloop holds Cs [64][52] f32 and Ps [3][64][20]
// f32 | Rs [64][16] f32
__host__ __device__ constexpr size_t p_off_ur(int H) {
  return align128(static_cast<size_t>(H) * kBLd * 2);
}
__host__ __device__ constexpr size_t p_off_ring(int H) {
  return p_off_ur(H) + align128(static_cast<size_t>(kTile) * g_ld(H) * 2);
}
__host__ __device__ constexpr size_t p_off_cs(int H) { return p_off_ring(H); }
__host__ __device__ constexpr size_t p_off_ps(int H) {
  return p_off_cs(H) + kCsBytes;
}
__host__ __device__ constexpr size_t p_off_rs(int H) {
  return p_off_ring(H) + kStages * kStageBytes;
}
__host__ __device__ constexpr size_t bptt_smem_bytes(int H) {
  return p_off_rs(H) + static_cast<size_t>(kRows) * kTile * 4;
}

// One direction's arguments of the persistent step kernel.
template <class E>
struct Bptt {
  const float* gx;               // [T, B, 3H]
  const float* hseq;             // [T, B, H] f32 (the forward's states)
  E* hbf;                        // [T, B, H] E copy (pre-step slices)
  const int* lens;               // [B]
  const E* uh;                   // [H, 3H]
  const float* bhn;              // [H]
  float* dhe;                    // [B, H] in/out
  float* dgx;                    // [T, B, 3H]
  E* g;                          // [T, B, 3H]
  float* part;                   // [T, ceil(B/16), H]
  int T, B, H, reverse;
};

template <class E>
__global__ void __launch_bounds__(kThreads, 1)
gru_bptt_kernel(Bptt<E> p0, Bptt<E> p1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Bptt<E> p = blockIdx.z == 0 ? p0 : p1;
  const int H = p.H;
  const int B = p.B;
  const int T = p.T;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t step_gx = static_cast<size_t>(B) * H3;
  const int ldr = g_ld(H);
  E* Uc = reinterpret_cast<E*>(smem);
  E* Ur = reinterpret_cast<E*>(smem + p_off_ur(H));
  unsigned char* ring = smem + p_off_ring(H);
  float* Cs = reinterpret_cast<float*>(smem + p_off_cs(H));
  float* Ps = reinterpret_cast<float*>(smem + p_off_ps(H));
  float* Rs = reinterpret_cast<float*>(smem + p_off_rs(H));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j0 = blockIdx.x * kTile;

  // U_h columns j0.., H+j0.., 2H+j0.. of every row, and rows j0..j0+15.
  for (int i = tid; i < H * 6; i += kThreads) {
    const int k = i / 6;
    const int sl = i - k * 6;
    const int g = sl >> 1;
    const int half = (sl & 1) * 8;
    cp_async16(Uc + k * kBLd + g * kTile + half,
               p.uh + k * H3 + g * H + j0 + half, true);
  }
  const int v8 = static_cast<int>(H3 / 8);
  for (int i = tid; i < kTile * v8; i += kThreads) {
    const int row = i / v8;
    const int c = (i - row * v8) * 8;
    cp_async16(Ur + row * ldr + c, p.uh + (j0 + row) * H3 + c, true);
  }
  cp_async_commit();

  // E copy of the pre-step states: hseq[0..T-2] (forward) or
  // hseq[1..T-1] (reverse), rounded as the reference rounds h_prev, by the
  // gridDim.x * gridDim.y blocks of this direction together, four floats a
  // thread and load, 8 loads in flight a pass.
  if (T > 1) {
    constexpr int kBatch = 8;
    const size_t off = p.reverse ? step_h : 0;
    const float4* src = reinterpret_cast<const float4*>(p.hseq + off);
    using Pair = typename Elem<E>::pair;
    Pair* dst = reinterpret_cast<Pair*>(p.hbf + off);
    const size_t n4 = (T - 1) * step_h / 4;
    const size_t nthreads =
        static_cast<size_t>(gridDim.x) * gridDim.y * kThreads;
    for (size_t i0 = (static_cast<size_t>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * kThreads + tid;
         i0 < n4; i0 += kBatch * nthreads) {
      float4 h[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t i = i0 + u * nthreads;
        if (i < n4) h[u] = __ldg(src + i);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t i = i0 + u * nthreads;
        if (i < n4) {
          dst[2 * i] = Elem<E>::from2(h[u].x, h[u].y);
          dst[2 * i + 1] = Elem<E>::from2(h[u].z, h[u].w);
        }
      }
    }
  }
  cp_async_wait<0>();
  cgrp::grid_group grid = cgrp::this_grid();
  grid.sync();

  const int nbt = (B + kTile - 1) / kTile;
  const int ntiles = (B + kRows - 1) / kRows;
  const int nchunk = H / kKc;
  const int rb = warp >> 1;            // the warp's 16 rows of the b-tile
  const bool gate_warp = (warp & 1) == 0;
  const int jl = tid & (kTile - 1);
  const int j = j0 + jl;
  const float bhn_j = __ldg(p.bhn + j);

  for (int k = 0; k < T; ++k) {
    const int t = p.reverse ? k : T - 1 - k;
    const bool first = p.reverse ? t == T - 1 : t == 0;
    const size_t tp = static_cast<size_t>(p.reverse ? t + 1 : t - 1);
    // h_prev == null: the zero initial state (its E tile is zero-filled
    // and gh still runs). g_prev == null: the
    // first BPTT step, whose dh is `dhe` as given.
    const E* hb = first ? nullptr : p.hbf + tp * step_h;
    const float* hf = first ? nullptr : p.hseq + tp * step_h;
    const E* gp =
        k == 0 ? nullptr : p.g + (p.reverse ? t - 1 : t + 1) * step_gx;
    const float* gxt = p.gx + t * step_gx;
    float* dgxt = p.dgx + t * step_gx;
    E* gt = p.g + t * step_gx;
    float* part = p.part + static_cast<size_t>(k) * nbt * H;

    for (int bt = blockIdx.y; bt < ntiles; bt += gridDim.y) {
      const int b0 = bt * kRows;
      // Stage c: columns c*64.. of E(h_prev), and of each gate of G_prev,
      // 16 bytes a copy.
      auto load_stage = [&](int c, int slot) {
        constexpr int kV = kKc / 8;
        E* Ah = reinterpret_cast<E*>(ring + slot * kStageBytes);
        E* Ag = Ah + kRows * kHLd;
#pragma unroll
        for (int u = 0; u < kRows * kV / kThreads; ++u) {
          const int i = tid + u * kThreads;
          const int row = i / kV;
          const int q = (i - row * kV) * 8;
          const int b = b0 + row;
          const bool ok = hb != nullptr && b < B;
          cp_async16(Ah + row * kHLd + q,
                     ok ? hb + static_cast<size_t>(b) * H + c * kKc + q
                        : p.hbf,
                     ok);
        }
        if (gp != nullptr) {
#pragma unroll
          for (int u = 0; u < kRows * 3 * kV / kThreads; ++u) {
            const int i = tid + u * kThreads;
            const int row = i / (3 * kV);
            const int r = i - row * 3 * kV;
            const int g = r / kV;
            const int q = (r - g * kV) * 8;
            const int b = b0 + row;
            const bool ok = b < B;
            cp_async16(Ag + row * kGsLd + g * kKc + q,
                       ok ? gp + b * H3 + g * H + c * kKc + q : gp, ok);
          }
        }
      };

      // The elementwise operands of the thread's 4 rows, loaded ahead of
      // the mainloop so that it hides their latency. Only `dhe` changes
      // during the call, and only this thread writes its entries.
      float xr[4], xz[4], xn[4], hpv[4], dhv[4];
      int lenv[4];
#pragma unroll
      for (int q = 0; q < kRows / 16; ++q) {
        const int b = b0 + (tid >> 4) + 16 * q;
        xr[q] = xz[q] = xn[q] = hpv[q] = dhv[q] = 0.0f;
        lenv[q] = 0;
        if (b < B) {
          const size_t o = static_cast<size_t>(b) * H + j;
          const float* g = gxt + b * H3;
          xr[q] = __ldg(g + j);
          xz[q] = __ldg(g + H + j);
          xn[q] = __ldg(g + 2 * H + j);
          hpv[q] = hf != nullptr ? __ldg(hf + o) : 0.0f;
          dhv[q] = p.dhe[o];
          lenv[q] = __ldg(p.lens + b);
        }
      }

      float acc[3][8];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nchunk) load_stage(s, s);
        cp_async_commit();
      }
      for (int c = 0; c < nchunk; ++c) {
        cp_async_wait<kStages - 2>();
        __syncthreads();
        const int nx = c + kStages - 1;
        if (nx < nchunk) load_stage(nx, nx % kStages);
        cp_async_commit();
        const E* Ah =
            reinterpret_cast<const E*>(ring + (c % kStages) * kStageBytes);
        const E* Ag = Ah + kRows * kHLd;
        if (gate_warp) {
          // gh = E(h_prev) U_h for the 3 gates of rows rb*16..; U_h's
          // columns sit k-major in Uc.
#pragma unroll
          for (int ks = 0; ks < kKc; ks += 16) {
            unsigned af[4];
            load_a(af, Ah + rb * 16 * kHLd + ks, kHLd, lane);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              unsigned bf[4];
              load_b_kmajor(bf, Uc + (c * kKc + ks) * kBLd + g * kTile,
                            kBLd, lane);
              mma16<E>(acc[g], af, bf);
            }
          }
        } else if (gp != nullptr) {
          // gate chunk g of G_prev U_h^T; U_h's rows are the columns of
          // U_h^T, so Ur holds that B operand n-major.
#pragma unroll
          for (int g = 0; g < 3; ++g) {
#pragma unroll
            for (int ks = 0; ks < kKc; ks += 16) {
              unsigned af[4], bf[4];
              load_a(af, Ag + rb * 16 * kGsLd + g * kKc + ks, kGsLd, lane);
              load_b_nmajor(bf, Ur + g * H + c * kKc + ks, ldr, lane);
              mma16<E>(acc[g], af, bf);
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // Cs and Ps overwrite the ring
      if (gate_warp) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          store_acc(Cs + rb * 16 * kCLd + g * kTile, kCLd, acc[g], lane);
      } else if (gp != nullptr) {
#pragma unroll
        for (int g = 0; g < 3; ++g)
          store_acc(Ps + (g * kRows + rb * 16) * kPLd, kPLd, acc[g], lane);
      }
      __syncthreads();

      // The elementwise step (the math above), 4 rows a thread.
#pragma unroll
      for (int q = 0; q < kRows / 16; ++q) {
        const int bl = (tid >> 4) + 16 * q;
        const int b = b0 + bl;
        float dgh_n = 0.0f;
        if (b < B) {
          const size_t o = static_cast<size_t>(b) * H + j;
          float dh = dhv[q];
          if (gp != nullptr) {
            const int pi = bl * kPLd + jl;
            dh = ((dh + Ps[pi]) + Ps[kRows * kPLd + pi]) +
                 Ps[2 * kRows * kPLd + pi];
          }
          const float* gh = Cs + bl * kCLd + jl;
          const float ghn_b = gh[2 * kTile] + bhn_j;
          const float r = sigmoid(xr[q] + gh[0]);
          const float z = sigmoid(xz[q] + gh[kTile]);
          const float n = tanhf(xn[q] + r * ghn_b);
          const float hp = hpv[q];
          const float m = t < lenv[q] ? 1.0f : 0.0f;
          const float dh_new = m * dh;
          const float dhp = (1.0f - m) * dh + dh_new * z;
          const float dz = dh_new * (hp - n);
          const float dn = dh_new * (1.0f - z);
          const float da_n = dn * (1.0f - n * n);
          const float dr = da_n * ghn_b;
          dgh_n = da_n * r;
          const float da_r = dr * r * (1.0f - r);
          const float da_z = dz * z * (1.0f - z);
          float* dg = dgxt + b * H3;
          dg[j] = da_r;
          dg[H + j] = da_z;
          dg[2 * H + j] = da_n;
          E* go = gt + b * H3;
          go[j] = Elem<E>::from(da_r);
          go[H + j] = Elem<E>::from(da_z);
          go[2 * H + j] = Elem<E>::from(dgh_n);
          p.dhe[o] = dhp;
        }
        Rs[bl * kTile + jl] = dgh_n;
      }
      __syncthreads();
      if (tid < kRows) {  // dgh_n summed over each 16-row group, in order
        const int grp = tid >> 4;
        const int bt16 = b0 / kTile + grp;
        float sum = 0.0f;
        for (int i = 0; i < kTile; ++i) {
          sum += Rs[(grp * kTile + i) * kTile + jl];
        }
        if (bt16 < nbt) part[static_cast<size_t>(bt16) * H + j] = sum;
      }
    }
    if (k + 1 < T) grid.sync();
  }
}

constexpr int kDM = 128;  // dU_h rows (hidden units i) per block
constexpr int kDN = 64;   // dU_h columns (gate outputs) per block
constexpr int kDK = 128;  // rows of K per ring stage
constexpr int kDStages = 4;
constexpr int kDALd = kDM + 8;
constexpr int kDBLd = kDN + 8;
constexpr size_t kDStageBytes =
    static_cast<size_t>(kDK) * (kDALd + kDBLd) * 2;
constexpr size_t kDuhSmem = kDStages * kDStageBytes;

// One direction's dU_h [H, 3H] = sum_k hp[k, :]^T g[k, :] over K rows, hp
// the E copy.
template <class E>
struct DuhPipe {
  const E* hp;                 // [K, H]
  const E* g;                  // [K, 3H]
  float* duh;                  // [H, 3H]
  int K, H;
};

template <class E>
__global__ void __launch_bounds__(kThreads, 1)
gru_duh_pipe_kernel(DuhPipe<E> d0, DuhPipe<E> d1) {
  extern __shared__ __align__(128) unsigned char smem[];
  const DuhPipe<E> d = blockIdx.z == 0 ? d0 : d1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wr = warp >> 1;  // 4 x 2 warps of 32 x 32
  const int wc = warp & 1;
  const int i0 = blockIdx.y * kDM;
  const int n0 = blockIdx.x * kDN;
  const int H = d.H;
  const int K = d.K;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const bool live = i0 + wr * 32 < H;  // H % 64 == 0: whole warp rows
  // The k-steps: K rounded up to 32 (the rows past K are zero-filled).
  const int kend = (K + 31) / 32 * 32;

  auto load_stage = [&](int c, int slot) {
    E* As = reinterpret_cast<E*>(smem + slot * kDStageBytes);
    E* Bs = As + kDK * kDALd;
    const int k0 = c * kDK;
    for (int i = tid; i < kDK * kDM / 8; i += kThreads) {
      const int r = i >> 4;
      const int q = (i & 15) * 8;
      const bool ok = k0 + r < K && i0 + q < H;
      cp_async16(As + r * kDALd + q,
                 ok ? d.hp + static_cast<size_t>(k0 + r) * H + i0 + q : d.hp,
                 ok);
    }
    for (int i = tid; i < kDK * kDN / 8; i += kThreads) {
      const int r = i >> 3;
      const int q = (i & 7) * 8;
      const bool ok = k0 + r < K;
      cp_async16(Bs + r * kDBLd + q,
                 ok ? d.g + static_cast<size_t>(k0 + r) * H3 + n0 + q : d.g,
                 ok);
    }
  };

  float acc[2][2][8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][c][e] = 0.0f;

  const int nk = (K + kDK - 1) / kDK;
#pragma unroll
  for (int s = 0; s < kDStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < nk; ++c) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();
    const int nx = c + kDStages - 1;
    if (nx < nk) load_stage(nx, nx % kDStages);
    cp_async_commit();
    const E* As =
        reinterpret_cast<const E*>(smem + (c % kDStages) * kDStageBytes);
    const E* Bs = As + kDK * kDALd;
    if (!live) continue;
    const int nkk = kend - c * kDK;  // the stage's k-steps, 16 rows each
#pragma unroll
    for (int kk = 0; kk < kDK; kk += 16) {
      if (kk >= nkk) break;
      // A = E(h_prev)^T, held k-major ([k][i]) as G.
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        load_a_kmajor(af[a], As + kk * kDALd + wr * 32 + a * 16, kDALd,
                      lane);
        load_b_kmajor(bf[a], Bs + kk * kDBLd + wc * 32 + a * 16, kDBLd,
                      lane);
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c2 = 0; c2 < 2; ++c2) mma16<E>(acc[a][c2], af[a], bf[c2]);
    }
  }
  cp_async_wait<0>();
  if (!live) return;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      store_acc(d.duh + static_cast<size_t>(i0 + wr * 32 + a * 16) * H3 +
                    n0 + wc * 32 + c * 16,
                H3, acc[a][c], lane);
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

// Resident blocks per SM of gru_bptt_kernel at width H (0 where its shared
// memory exceeds what a block may have), the dynamic shared memory it
// takes, and the widest H, a multiple of 64, whose shared memory fits on
// the current device; grants the kernel that memory where it fits.
template <class E>
cudaError_t bptt_occupancy(int H, int* per_sm, size_t* smem,
                           int* max_width) {
  *per_sm = 0;
  *smem = bptt_smem_bytes(H);
  *max_width = 0;
  int dev = 0, optin = 0, coop = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  while (bptt_smem_bytes(*max_width + 64) <= static_cast<size_t>(optin))
    *max_width += 64;
  if (*smem > static_cast<size_t>(optin)) return cudaSuccess;
  e = cudaFuncSetAttribute(gru_bptt_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(*smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gru_bptt_kernel<E>, kThreads, *smem);
}

// The BPTT of `dirs` (1 or 2) recurrences on `st`: the persistent step
// kernel, cooperatively, on H / 16 j-tiles x `rows` rows of blocks x
// `dirs` (ops/kernels.py::gru_bwd_plan's grid), then the dU_h GEMM and the
// db_hn sum of every direction, all three launches for all directions at
// once. p[d], duh[d] ([H, 3H] f32) and dbhn[d] ([H] f32) are direction
// d's; those of direction 1 are read only where dirs == 2. Counts in
// *launched the kernels that launched; returns the first CUDA error, among
// them cudaErrorCooperativeLaunchTooLarge where the grid cannot be resident
// at once, clearing it from the runtime so that later launch checks of
// other kernels do not report it again.
template <class E>
int bptt_run(const Bptt<E> (&p)[2], float* const (&duh)[2],
             float* const (&dbhn)[2], int dirs, int rows, cudaStream_t st,
             int* launched) {
  *launched = 0;
  const int T = p[0].T;
  const int B = p[0].B;
  const int H = p[0].H;
  int per_sm = 0, max_width = 0;
  size_t smem = 0;
  cudaError_t e = bptt_occupancy<E>(H, &per_sm, &smem, &max_width);
  if (e == cudaSuccess &&
      (T < 1 || B < 1 || H < 64 || H % 64 != 0 || dirs < 1 || dirs > 2 ||
       rows < 1 || per_sm < 1))
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  Bptt<E> p0 = p[0], p1 = p[1];
  void* args[] = {&p0, &p1};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gru_bptt_kernel<E>),
      dim3(H / kTile, rows, dirs), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  ++*launched;
  e = cudaFuncSetAttribute(gru_duh_pipe_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kDuhSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // h_prev of step t is hseq[t-1] (forward) or hseq[t+1] (reverse); the
  // first processed step's zero state adds nothing and is left out.
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t step_gx = 3 * step_h;
  DuhPipe<E> d[2];
  for (int i = 0; i < 2; ++i) {
    d[i] = DuhPipe<E>{p[i].hbf + (p[i].reverse ? step_h : 0),
                      p[i].g + (p[i].reverse ? 0 : step_gx), duh[i],
                      (T - 1) * B, H};
  }
  gru_duh_pipe_kernel<E><<<dim3(3 * H / kDN, (H + kDM - 1) / kDM, dirs),
                           kThreads, kDuhSmem, st>>>(d[0], d[1]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  ++*launched;
  const int nbt = (B + kTile - 1) / kTile;
  gru_dbhn_kernel<<<dim3((H + 255) / 256, dirs), 256, 0, st>>>(
      DbhnSum{p[0].part, dbhn[0]}, DbhnSum{p[1].part, dbhn[1]}, T * nbt, H);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++*launched;
  return static_cast<int>(e);
}

}  // namespace
