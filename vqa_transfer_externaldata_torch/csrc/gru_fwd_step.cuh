// The GRU forward recurrence for Hopper (sm_90a): the cell (gru_cell), the
// persistent kernel (gru_seq_kernel) and its cooperative launch (seq_run),
// which K1 `gru_fwd` (csrc/gru_fwd.cu, one direction) and K6 `bigru_fwd`
// (csrc/bigru_fwd.cu, both directions of a bidirectional GRU) share. The
// step math is vqa_transfer_externaldata_tpu/ops/gru.py::_gru_cell:
//
//   gh = E(h) @ U_h                         (f32 accumulation)
//   r  = sigmoid(gx_r + gh_r),  z = sigmoid(gx_z + gh_z)
//   n  = tanh(gx_n + r * (gh_n + b_hn))
//   h' = (1 - z) * n + z * h                applied only where t < lens[b]
//
// gx = x @ W_x + b is computed once for all steps outside (a plain GEMM).
// E is U_h's 16-bit type, bf16 (K1, K6) or float16 (K1h): the state is
// rounded to it ahead of the product, as JAX's h.astype(uh.dtype), and the
// products run on mma.sync of that type (elem16.cuh).
// `reverse` walks t from T-1 down to 0 under the same prefix mask, so the
// padded tail is processed first and carries the zero state through.
//
// Design: the TPU kernels keep h in VMEM across a sequential grid and U_h
// (1.5 MB of bf16) resident beside it. Here gru_seq_kernel is ONE
// cooperative launch for all T steps, separated by grid-wide barriers.
// Block (jx, by, d) owns 16 hidden units j0 = 16 * jx.. of direction d for
// the whole call and loads its 48 columns {j0, H+j0, 2H+j0} + 0..15 of that
// direction's U_h into shared memory once. blockIdx.z picks the direction:
// the kernel takes one FwdSeq a direction, so one launch advances both
// chains of a bidirectional GRU, step k of the forward chain (t = k) and of
// the backward chain (t = T-1-k) between the same two barriers, as the
// Pallas grid step of _bigru_fwd_kernel does; a one-direction launch
// (gridDim.z == 1) reads only the first. Within a step a block walks its
// b-tiles of `rows` rows (by, by + gridDim.y, ...). The state that blocks
// exchange is an E copy of h_t, rounded as the reference rounds h before
// its matmul, in a ping-pong pair [2, B, H] a direction: step k reads slot
// (k+1) % 2 and writes slot k % 2, so one barrier a step suffices (no block
// writes a slot before every block has finished reading it). A b-tile's
// rows of that copy come in through cp.async.cg (L2 only: other blocks
// wrote them before the barrier), every column in flight at once, 64
// columns a commit group, so the products start on the first group while
// the rest arrive. Warp w takes rows 16 (w / 2).. and the n8 half w % 2 of
// all three gates: three chains of mma.sync m16n8k16 fed by ldmatrix
// (mma_sync.cuh), k ascending from a zero accumulator. Each lane applies
// gru_cell to its 4 elements straight from the accumulators; the f32
// h_prev it needs is its own element of the step before, which it wrote
// to hseq itself. gx does not depend on the recurrence, so the next work
// item's [rows, 48] slice is copied with cp.async into the other of two
// buffers during the current item.
//
// Two tilings: 16 rows a block where every b-tile of every direction is
// resident at once (B <= 128 at H = 512 for one direction: 8 b-tiles x 32
// j-tiles on 132 SMs, two blocks an SM), since a block's step is shorter
// the fewer rows of h_prev it reads; else 64 rows, the rows of blocks
// walking b-tiles (B = 256: 32 x 4 blocks for one direction, 32 x 2 x 2
// for two, one an SM). A 64-row block fits up to H = 848 and a 16-row one
// up to H = 1568; wider (or where not even one row of j-tiles can be
// resident), ops/kernels.py::gru_fwd_route sends the wrappers to the step
// form of gru_wide_step.cuh, which reads U_h through L2 one launch a step.
// At 1568 a 16-row block's U_h slice alone is 175 KB; at Skip-Thought's
// 2400 units it would be 269 KB, and its 150 j-tiles could not be resident
// together on 132 SMs even if it fit. ops/kernels.py::gru_fwd_plan
// picks the rows; seq_grid derives the grid from them and from the
// occupancy query, as the plan does, so that the grid is resident at once,
// and the cooperative launch refuses one that cannot be. Where both
// directions' j-tiles cannot be resident together but one direction's can
// (H above 1056 on an H100), seq_run launches the same kernel once a
// direction, one after the other on the same stream.
//
// Every direction of a launch takes the same products in the same order,
// the same rounding of h_prev and the same gru_cell as a one-direction
// launch: K6's chains equal K1 calls bit for bit. No atomics: the result is
// deterministic.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "mma_sync.cuh"  // and elem16.cuh

namespace {

namespace cgrp = cooperative_groups;

constexpr int kSeqThreads = 256;  // 8 warps, one (16-row, n8-half) task each
constexpr int kUnits = 16;        // hidden units a block owns
constexpr int kHalves = kUnits / 8;  // n8 halves of a gate's units
constexpr int kChunk = 64;        // h_prev columns in one cp.async group
// Leading dimension of the U_h slice [H][48] of E: a row is 7 (an odd
// number of) 16-byte units, so ldmatrix's 8 rows hit distinct banks.
constexpr int kULd = 3 * kUnits + 8;
constexpr int kXLd = 3 * kUnits;  // floats of a row of a gx slice

__host__ __device__ constexpr int a_ld(int H) { return H + 8; }

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Us [H][kULd] E | Hs [rows][H+8] E | Xs [2][rows][48] f32 (E: 2 bytes)
__host__ __device__ constexpr size_t seq_off_h(int H) {
  return align128(static_cast<size_t>(H) * kULd * 2);
}
__host__ __device__ constexpr size_t seq_off_x(int H, int rows) {
  return seq_off_h(H) + align128(static_cast<size_t>(rows) * a_ld(H) * 2);
}
__host__ __device__ constexpr size_t seq_smem_bytes(int H, int rows) {
  return seq_off_x(H, rows) + 2 * static_cast<size_t>(rows) * kXLd * 4;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One element of the step: x* = gx of the gates, gh* = E(h_prev) @ U_h
// of the gates, hp = the f32 state before the step, live = t < lens[b].
__device__ __forceinline__ float gru_cell(float xr, float xz, float xn,
                                          float ghr, float ghz, float ghn,
                                          float bhn, float hp, bool live) {
  const float r = sigmoid(xr + ghr);
  const float z = sigmoid(xz + ghz);
  const float n = tanhf(xn + r * (ghn + bhn));
  const float h_new = (1.0f - z) * n + z * hp;
  return live ? h_new : hp;
}

// Waits until at most n of this thread's cp.async groups are pending
// (waiting for more is always safe, so n above 7 waits as for 7).
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// One direction's recurrence, U_h and the exchanged state in E.
template <class E>
struct FwdSeq {
  const float* gx;             // [T, B, 3H]
  const int* lens;             // [B]
  const E* uh;                 // [H, 3H]
  const float* bhn;            // [H]
  float* hseq;                 // [T, B, H]
  float* hT;                   // [B, H]
  E* hbf;                      // [2, B, H] E copies of the state
  int T, B, H, rows, reverse;
};

template <class E>
__global__ void __launch_bounds__(kSeqThreads)
gru_seq_kernel(FwdSeq<E> d0, FwdSeq<E> d1) {
  const FwdSeq<E> p = blockIdx.z == 0 ? d0 : d1;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int U = kUnits;
  const int H = p.H;
  const int B = p.B;
  const int T = p.T;
  const int rows = p.rows;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const size_t step_h = static_cast<size_t>(B) * H;
  const size_t step_gx = static_cast<size_t>(B) * H3;
  const int lda = a_ld(H);
  E* Us = reinterpret_cast<E*>(smem);
  E* Hs = reinterpret_cast<E*>(smem + seq_off_h(H));
  float* Xs = reinterpret_cast<float*>(smem + seq_off_x(H, rows));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int j0 = blockIdx.x * U;
  const int ntiles = (B + rows - 1) / rows;
  const int nchunk = (H + kChunk - 1) / kChunk;

  // The gx slice of work item (step k, b-tile bt) into buffer `buf`, as one
  // commit group; rows past B are zero-filled.
  auto load_gx = [&](int k, int bt, int buf) {
    constexpr int kQ = U / 4;  // 16-byte copies a gate and row
    const float* src = p.gx + (p.reverse ? T - 1 - k : k) * step_gx;
    float* dst = Xs + buf * rows * kXLd;
    const int b0 = bt * rows;
    for (int i = tid; i < rows * 3 * kQ; i += kSeqThreads) {
      const int r = i / (3 * kQ);
      const int s = i - r * 3 * kQ;
      const int g = s / kQ;
      const int q = (s - g * kQ) * 4;
      const int b = b0 + r;
      const bool ok = b < B;
      cp_async16(dst + r * kXLd + g * U + q,
                 ok ? src + b * H3 + g * H + j0 + q : src, ok);
    }
    cp_async_commit();
  };

  // U_h columns j0.., H+j0.., 2H+j0.. of every row, in the first group with
  // the first item's gx.
  for (int i = tid; i < H * 3 * kHalves; i += kSeqThreads) {
    const int k = i / (3 * kHalves);
    const int s = i - k * 3 * kHalves;
    const int g = s / kHalves;
    const int q = (s - g * kHalves) * 8;
    cp_async16(Us + k * kULd + g * U + q, p.uh + k * H3 + g * H + j0 + q,
               true);
  }
  load_gx(0, blockIdx.y, 0);

  // The warp's task: rows rg*16.. of a b-tile, units half*8.. of the block.
  // Its lane's elements: rows er and er + 8, units j and j + 1.
  const bool mma_warp = warp < rows / 16 * kHalves;
  const int rg = warp / kHalves;
  const int half = warp % kHalves;
  const int er = rg * 16 + (lane >> 2);
  const int j = j0 + half * 8 + 2 * (lane & 3);
  const float bhn0 = mma_warp ? __ldg(p.bhn + j) : 0.0f;
  const float bhn1 = mma_warp ? __ldg(p.bhn + j + 1) : 0.0f;

  cgrp::grid_group grid = cgrp::this_grid();
  int item = 0;  // the block's work items so far: parity picks the gx buffer
  for (int k = 0; k < T; ++k) {
    const int t = p.reverse ? T - 1 - k : k;
    // null at the first step: the zero initial state (its E tile is
    // zero-filled and the products still run).
    const E* hb =
        k == 0 ? nullptr : p.hbf + ((k + 1) & 1) * step_h;
    const float* hf =
        k == 0 ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * step_h;
    float* ho = p.hseq + t * step_h;
    E* hbo = p.hbf + (k & 1) * step_h;
    float* hTo = k == T - 1 ? p.hT : nullptr;

    for (int bt = blockIdx.y; bt < ntiles; bt += gridDim.y, ++item) {
      const int b0 = bt * rows;
      // E(h_prev) of the tile's rows, 64 columns a commit group.
      for (int c = 0; c < nchunk; ++c) {
        const int cw = min(kChunk, H - c * kChunk) / 8;
        for (int i = tid; i < rows * cw; i += kSeqThreads) {
          // A whole chunk's row is 8 copies: a shift, not a division by a
          // runtime count, on the path every step takes.
          const int r = cw == kChunk / 8 ? i >> 3 : i / cw;
          const int q = c * kChunk + (i - r * cw) * 8;
          const int b = b0 + r;
          const bool ok = hb != nullptr && b < B;
          cp_async16(Hs + r * lda + q,
                     ok ? hb + static_cast<size_t>(b) * H + q : p.hbf, ok);
        }
        cp_async_commit();
      }
      // The elementwise operands that come from device memory, loaded ahead
      // of the products: the lane's own f32 h_prev and the rows' lengths.
      float2 hp[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
      bool live[2] = {false, false};
      if (mma_warp) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = b0 + er + 8 * e;
          if (b < B) {
            if (hf != nullptr) {
              hp[e] = *reinterpret_cast<const float2*>(
                  hf + static_cast<size_t>(b) * H + j);
            }
            live[e] = t < __ldg(p.lens + b);
          }
        }
      }
      int next_k = k;
      int next_bt = bt + gridDim.y;
      if (next_bt >= ntiles) {
        next_k = k + 1;
        next_bt = blockIdx.y;
      }
      const bool has_next = next_k < T;

      float acc[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = 0.0f;
      for (int c = 0; c < nchunk; ++c) {
        // Chunk c and everything committed before this item's chunks (U_h
        // and this item's gx slice at c = 0) have landed; the next item's
        // gx, committed at c = 0, may stay in flight.
        cp_async_wait_upto(nchunk - 1 - c + (c > 0 && has_next ? 1 : 0));
        __syncthreads();
        // Every thread is past the item before, which read the other gx
        // buffer: refill it for the next item.
        if (c == 0 && has_next) load_gx(next_k, next_bt, (item + 1) & 1);
        if (mma_warp) {
          const int kend = min(H, (c + 1) * kChunk);
          for (int kk = c * kChunk; kk < kend; kk += 16) {
            unsigned a[4];
            load_a(a, Hs + rg * 16 * lda + kk, lda, lane);
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              unsigned b[2];
              load_b_half_kmajor(b, Us + kk * kULd + g * U + half * 8,
                                 kULd, lane);
              mma16816<E>(acc[g], a, b[0], b[1]);
            }
          }
        }
      }
      __syncthreads();  // Hs is free for the next item

      if (mma_warp) {
        const float* X = Xs + (item & 1) * rows * kXLd;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rl = er + 8 * e;
          const int b = b0 + rl;
          if (b >= B) continue;
          const float* x = X + rl * kXLd + (j - j0);
          const float2 xr = *reinterpret_cast<const float2*>(x);
          const float2 xz = *reinterpret_cast<const float2*>(x + U);
          const float2 xn = *reinterpret_cast<const float2*>(x + 2 * U);
          float2 h;
          h.x = gru_cell(xr.x, xz.x, xn.x, acc[0][2 * e], acc[1][2 * e],
                         acc[2][2 * e], bhn0, hp[e].x, live[e]);
          h.y = gru_cell(xr.y, xz.y, xn.y, acc[0][2 * e + 1],
                         acc[1][2 * e + 1], acc[2][2 * e + 1], bhn1, hp[e].y,
                         live[e]);
          const size_t o = static_cast<size_t>(b) * H + j;
          *reinterpret_cast<float2*>(ho + o) = h;
          if (hTo != nullptr) *reinterpret_cast<float2*>(hTo + o) = h;
          *reinterpret_cast<typename Elem<E>::pair*>(hbo + o) =
              Elem<E>::from2(h.x, h.y);
        }
      }
    }
    if (k + 1 < T) grid.sync();
  }
}

// The dynamic shared memory of a block of `rows` (16 or 64) batch rows at
// width H, granted to the kernel, and the blocks of it resident per SM (0
// where that memory exceeds what a block may have).
template <class E>
cudaError_t seq_occupancy(int H, int rows, int* per_sm, size_t* smem) {
  *per_sm = 0;
  *smem = 0;
  if (H < 16 || H % 16 != 0 || (rows != 16 && rows != 64))
    return cudaErrorInvalidValue;
  *smem = seq_smem_bytes(H, rows);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess || *smem > static_cast<size_t>(optin)) return e;
  e = cudaFuncSetAttribute(gru_seq_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(*smem));
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, gru_seq_kernel<E>, kSeqThreads, *smem);
}

// The grid of `dirs` (1 or 2) recurrences at batch B: H / 16 j-tiles x as
// many rows of blocks as there are b-tiles of `rows` rows, but no more
// than are resident beside every direction's (each then walks b-tiles by,
// by + grid.y, ...) x `dirs`, launched once. Where not even one row of
// every direction's j-tiles is resident at once but one direction's is,
// the grid of one direction (grid.z = 1), launched once a direction; 0 x 0
// x 0 where not even that is. ops/kernels.py::gru_fwd_plan computes the
// same grid from the same blocks per SM.
template <class E>
cudaError_t seq_grid(int B, int H, int rows, int dirs, dim3* grid,
                     int* per_sm, size_t* smem) {
  *grid = dim3(0, 0, 0);
  cudaError_t e = seq_occupancy<E>(H, rows, per_sm, smem);
  if (e != cudaSuccess) return e;
  if (dirs < 1 || dirs > 2) return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  const int jt = H / kUnits;
  for (int z = dirs; z >= 1 && grid->x == 0; --z) {
    const int rows_resident = *per_sm * sms / (z * jt);
    if (B >= 1 && rows_resident >= 1)
      *grid = dim3(jt, std::min((B + rows - 1) / rows, rows_resident), z);
  }
  return cudaSuccess;
}

// The recurrences p[0..dirs-1] on `st` with b-tiles of `rows` (16 or 64)
// rows, as ops/kernels.py::gru_fwd_plan chooses them; the grid is derived
// here (seq_grid). One cooperative launch of every direction where their
// j-tiles are resident together, else one a direction, in order. Counts in
// *launched the kernels that launched; returns the first CUDA error, among
// them cudaErrorCooperativeLaunchTooLarge where not even one direction's
// grid can be resident at once, clearing it from the runtime so that later
// launch checks of other kernels do not report it again.
template <class E>
int seq_run(const FwdSeq<E> (&p)[2], int dirs, int rows, cudaStream_t st,
            int* launched) {
  *launched = 0;
  dim3 grid;
  int per_sm = 0;
  size_t smem = 0;
  cudaError_t e =
      seq_grid<E>(p[0].B, p[0].H, rows, dirs, &grid, &per_sm, &smem);
  if (e == cudaSuccess && (p[0].T < 1 || p[0].B < 1))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess && grid.y == 0) e = cudaErrorCooperativeLaunchTooLarge;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int n = dirs / static_cast<int>(grid.z);
  for (int i = 0; i < n; ++i) {
    // With grid.z == dirs one launch takes p[0] and p[1]; with grid.z == 1
    // launch i reads only its first argument, p[i].
    FwdSeq<E> a = p[i];
    FwdSeq<E> b = p[grid.z == 1 ? i : 1];
    void* args[] = {&a, &b};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(gru_seq_kernel<E>), grid,
        dim3(kSeqThreads), args, smem, st);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(e);
    }
    ++*launched;
  }
  return 0;
}

// The launch of `dirs` recurrences at batch B and width H with b-tiles of
// `rows` rows on the current device, for the C entries' *_config: its grid
// (0 x 0 x 0 where not even one direction's j-tiles can be resident at
// once), the launches it takes, the blocks resident per SM (0 where the
// shared memory exceeds a block's) and the dynamic shared memory. Returns
// the CUDA error of the queries, clearing it from the runtime.
template <class E>
int seq_config(int B, int H, int rows, int dirs, int* grid, int* launches,
               int* per_sm, long long* smem_bytes) {
  dim3 g;
  size_t smem = 0;
  const cudaError_t e = seq_grid<E>(B, H, rows, dirs, &g, per_sm, &smem);
  if (e != cudaSuccess) cudaGetLastError();
  grid[0] = static_cast<int>(g.x);
  grid[1] = static_cast<int>(g.y);
  grid[2] = static_cast<int>(g.z);
  *launches = g.z == 0 ? 0 : dirs / static_cast<int>(g.z);
  *smem_bytes = static_cast<long long>(smem);
  return static_cast<int>(e);
}

}  // namespace
