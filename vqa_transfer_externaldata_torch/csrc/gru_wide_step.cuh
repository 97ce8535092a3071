// The step form of the 16-bit GRU recurrence and its BPTT for Hopper
// (sm_90a), for widths the persistent kernels do not take: the forward of
// K1/K6 past the crossover width (ops/kernels.py::GRU_FWD_STEP_ABOVE) or the
// U_h slice a block of gru_fwd_step.cuh can hold, the BPTT of K3/K7 past
// the slices and ring of gru_bwd_step.cuh (H above 576 on an H100). The
// libraries csrc/gru_fwd_wide.cu and csrc/gru_bwd_wide.cu build it (one
// direction for K1/K3, both on blockIdx.z for K6/K7), and their float16
// twins (*_wide_f16.cu) build it again with E = float16 (elem16.cuh).
//
// Replaces, at those widths, vqa_transfer_externaldata_tpu/ops/gru.py's
// _gru_fwd_kernel / _bigru_fwd_kernel (B1/B7) and _gru_bwd_kernel /
// _bigru_bwd_kernel (B2/B8), which pad only the batch and take any H. The
// math is that file's _gru_cell and _gru_cell_bwd, as gru_fwd_step.cuh and
// gru_bwd_step.cuh state it; the rounding points are JAX's: h_prev is
// rounded to E ahead of U_h (and of dU_h), the gate cotangents ahead of
// U_h^T and dU_h. Every elementwise product and sum is rounded on its own
// (__fmul_rn / __fadd_rn), as the plain version rounds them, so no
// contraction into an FMA is taken that JAX does not take.
//
// What bounds it on an H100: a step's product is 2 B H 3H operations (B =
// 256, H = 2400: 8.85 GFLOP, 9 us at the 16-bit peak) on U_h (34.6 MB of E,
// which the 50 MB L2 keeps between steps) and the state; the T dependent
// steps cannot overlap. A step is bound by the bytes its tiles read from
// L2 (each tile re-reads the operand it shares with the other tiles of its
// row or column), then by its elementwise epilogue's loads from HBM and
// its launch. Every 16-bit product is a GEMM tile on wgmma.
//
// Design: tile_gemm takes a 128- or 256-row x 128-column tile with 256
// threads (two warpgroups, 64 or 128 rows each), wgmma m64n128k16 on
// score_gemm.cuh's primitives (its cp.async ring of 64-wide K chunks, here
// 192 KB deep, the 128-byte swizzle and K-major descriptors, the proxy
// fence, the scale_d start), A K-major; then the accumulators go to
// shared memory and an elementwise epilogue reads them, its operands
// loaded 8 at a time a thread (the first 8 before the product), unit pairs
// through 8-byte loads and stores.
//  - The forward, one launch a step (gru_wide_fwd_kernel): a cluster of two
//    blocks (2 jx, 2 jx + 1; by; d) takes units 40 jx.. and rows 256 by..
//    of direction d, each block one half of gh = E(h_prev) @ U_h's K for
//    those units' r, z and n columns (120 of the tile's 128). B is read
//    from U_h as it lies, MN-major (attention_dwv.cuh's stage layout and
//    descriptor: five 16-byte chunks of a gate's columns a k row), so a
//    tile's columns are whole units. After the cluster's barrier each
//    block adds the halves (half 0's, then half 1's, one of them from its
//    peer's shared memory) for 128 of the rows and runs the cell: hseq[t],
//    the E copy of the state (ping-pong [2, B, H]) and hT. At B = 256,
//    H = 2400: 60 clusters, 120 blocks, one wave on 132 SMs; a step reads
//    U_h from L2 once and E(h_prev) once a column of tiles: about 110 MB.
//  - The BPTT, T + 3 + (directions) launches. gru_wide_round_kernel writes
//    the E copy of every pre-step state (rows of Hq = H rounded up to 256,
//    zero past H). gru_wide_gh_kernel computes every step's gh = E(h_prev)
//    @ U_h up front, off the chain, in one GEMM over the (T-1) B saved
//    states (256-row tiles, the forward's columns) into dgx's buffer:
//    [T, B, 3H] f32, 192 MB at H = 2400 and B = 256, which step t
//    overwrites with dgx[t] only after the step that read gh from that
//    slot. Then one gru_wide_carry_kernel a step, the first with no
//    product (dh = dh_T, the cotangent of the final state), each other
//    dh_prev = ((dpart + G_r U_r^T) + G_z U_z^T) + G_n U_n^T for a 128-row
//    x 128-unit tile, split by gate over a cluster of three blocks (each
//    K = H of one gate: A = the E gate cotangents G of the step before, B
//    = U_h's rows, K-major as they lie), the three sums added in that
//    order through distributed shared memory; its epilogue runs this
//    step's gate backward: dgx[t], G_t (gate blocks of Hq, zero past H),
//    dpart and a dgh_n partial a block, each rank of the cluster a third of
//    the tile's 16-row groups. At B = 256, H = 2400: 19 x 2 x 3 blocks a
//    carry step, U_h and G read from L2 twice and 19 times: about 140 MB a
//    step. Then dU_h = sum E(h_prev)^T G over the saved states, which is
//    attention_dwv.cuh's dW_v product (the same ring and wgmma on MN-major
//    operands: its reduction runs along the rows of both), one launch a
//    direction at Hq (the wrapper drops the padding's rows and columns),
//    and gru_bwd_step.cuh's gru_dbhn_kernel (db_hn over the partials in
//    step order).
//
// Each kernel takes the arguments of two recurrences and picks its own
// with blockIdx.z (blockIdx.y for the copy; the carry's clusters of z 3d ..
// 3d + 2): K1/K3 launch one direction, K6/K7 two. A block's work depends
// only on its own direction's arguments, so each direction of a
// two-direction call gives the bits of a one-direction call. No atomics:
// every sum has a fixed order, so the result is deterministic. Padding: the
// wrappers pad H to 16 with zero units, which stay exactly 0.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "attention_dwv.cuh"  // the dU_h product; score_gemm.cuh's wgmma
#include "gru_bwd_step.cuh"     // gru_dbhn_kernel; elem16.cuh

namespace {
namespace wide {

constexpr int kThreads = 256;  // two warpgroups
constexpr int kRows = 128;     // batch rows of a carry tile; a tile's
                               // rows an epilogue block takes
constexpr int kTall = 256;     // rows of a forward or gh tile
constexpr int kN = 128;        // columns of a tile: the wgmma's n
constexpr int kUnits = 40;     // units of a forward or gh tile: 3 x 40 columns
constexpr int kCarryUnits = kN;  // units of a carry tile (one gate's K)
constexpr int kBK = score_gemm::kBK;  // K of a ring stage
constexpr int kBBytes = kN * score_gemm::kRowBytes;
constexpr int kRingBytes = 192 * 1024;  // 6 stages of 128 rows, 4 of 256
constexpr int kCLd = kN + 8;  // the tile in f32 after the mainloop
// The BPTT's E copies of the states and gate cotangents are Hq = H rounded
// up to kDuhTile units wide (zero past H): dU_h's product takes whole
// 128-channel tiles, and 256-unit ones (its faster tile) where 3 Hq % 256
// == 0.
constexpr int kDuhTile = 256;
__host__ __device__ constexpr int duh_width(int H) {
  return (H + kDuhTile - 1) / kDuhTile * kDuhTile;
}
constexpr size_t kSmem = 1024 + kRingBytes;
static_assert(static_cast<size_t>(kTall) * kCLd * 4 <= kRingBytes,
              "the f32 tile reuses the ring after the mainloop");
static_assert(3 * kUnits <= kN, "a forward tile holds whole units");

// The ring of a tile of BM rows (128 or 256): A's 128-byte rows and B's,
// as many stages as fit in kRingBytes.
template <int BM>
struct Ring {
  static constexpr int kABytes = BM * score_gemm::kRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kRingBytes / kStageBytes;
  static constexpr int kAhead = kStages - 2;  // chunks the copies run ahead
};

__device__ __forceinline__ float wsigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One direction's forward at step k.
template <class E>
struct Fwd {
  const float* gx;   // [T, B, 3H]
  const int* lens;   // [B]
  const E* uh;       // [H, 3H]
  const float* bhn;  // [H]
  float* hseq;       // [T, B, H]
  float* hT;         // [B, H]
  E* hbf;            // [2, B, H] E copies of the state (ping-pong)
  int T, B, H, reverse;
};

// One direction's BPTT.
template <class E>
struct Bwd {
  const float* gx;    // [T, B, 3H]
  const float* hseq;  // [T, B, H] f32 (the forward's states)
  E* hbf;             // [T, B, Hq] E copy of the pre-step states, zero
                      // past H (Hq = duh_width(H))
  const int* lens;    // [B]
  const E* uh;        // [H, 3H]
  const float* bhn;   // [H]
  float* dpart;       // [B, H]: dh_T on entry, then the carry's part that
                      // skips U_h^T
  float* dgx;         // [T, B, 3H]: gh of every step, then dgx
  E* g;               // [T, B, 3Hq] E gate cotangents (gate blocks of Hq,
                      // zero past H)
  float* part;        // [T, 3 ceil(B/128), H] dgh_n partials: a step's,
                      // a carry block's rows
  int T, B, H, Hq, reverse;
};

// wgmma m64n128k16 with A K-major and B MN-major (tnsp-b 1), f32 sums of E
// products: score_gemm.cuh's n128 wrapper with its two layouts mixed.
#define GRU_WIDE_WGMMA_TB(TYPE) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPE "." TYPE " {" \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, " \
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, " \
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
      "%55, %56, %57, %58, %59, %60, %61, %62, %63" \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(da), "l"(db), "r"(scale_d))

template <class E>
__device__ __forceinline__ void wgmma_kmn(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  if constexpr (Elem<E>::kF16) {
    GRU_WIDE_WGMMA_TB("f16");
  } else {
    GRU_WIDE_WGMMA_TB("bf16");
  }
}

#undef GRU_WIDE_WGMMA_TB

// Where a tile's B operand comes from.
//  - Rows (the carry): tile column n is row n of a K-major matrix, b +
//    n ldb, rows at or past `rows` zero.
//  - GateColumns (the forward, every step's gh): tile column 8 q + e is
//    column g H + j0 + 8 c + e of U_h [K = H rows, 3H], g = q / 5, c =
//    q % 5: the r, z and n columns of the 40 units j0.. (chunk 15 and
//    units past H zero). U_h is read as it lies, MN-major, in
//    attention_dwv.cuh's stage layout (64-column atom columns of 64 k rows
//    in the 128-byte swizzle), so no transposed copy is made.
template <class E>
struct Rows {
  const E* b;
  size_t ldb;
  int rows;
};
template <class E>
struct GateColumns {
  const E* uh;
  int H, j0;
};

// acc = A @ B for the block's BM x 128 tile (BM 128 or 256): A's rows
// r < BM at a + r lda, K values of E each, K-major (rows at or past
// `arows` and K past `K` read as zero); B from `src` (Rows or
// GateColumns). K, lda, ldb and H are multiples of 8 and a, b, uh 16-byte
// aligned. `ring` is 1024-byte aligned. Warpgroup w takes rows w BM/2 ..:
// thread t ends holding score_gemm's m64n128 fragment of the 64-row
// sub-tiles s (rows w BM/2 + 64 s ..) in acc[s], with every copy landed
// and every MMA done, but without a barrier: the caller syncs before it
// reuses the ring. The sums run k ascending from a first wgmma with
// scale_d 0; K <= 0 gives zeros.
template <int BM, class E, class BSrc>
__device__ __forceinline__ void tile_gemm(const E* a, size_t lda, int arows,
                                          const BSrc& src, int K,
                                          unsigned char* ring,
                                          float (&acc)[BM / 128][kN / 2]) {
  namespace sg = score_gemm;
  using R = Ring<BM>;
  constexpr bool kGates = std::is_same<BSrc, GateColumns<E>>::value;
  constexpr int kACopies = BM / 32;
  constexpr int kSub = BM / 128;  // 64-row sub-tiles a warpgroup
  const int t = threadIdx.x;
  const int nk = K > 0 ? (K + kBK - 1) / kBK : 0;
  const int r0 = t >> 3;  // rows r0 + 32 j of A (and of K-major B)
  const int c = t & 7;    // 16-byte chunk c of each row of a stage
  // B: K-major rows as A's; or U_h's k rows (t >> 4) + 16 j, chunk t & 15.
  const E* bsrc[4];
  const int bq = t & 15;
  const int bk = t >> 4;
  size_t bld = 0;
  if constexpr (kGates) {
    const int g = bq / 5;
    const int cc = bq - 5 * g;
    const bool ok = bq < 15 && src.j0 + 8 * cc < src.H;
    bld = 3 * static_cast<size_t>(src.H);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bsrc[j] = ok ? src.uh + (bk + 16 * j) * bld + g * src.H + src.j0 +
                         8 * cc
                   : nullptr;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 32 * j;
      bsrc[j] = r < src.rows ? src.b + r * src.ldb + c * 8 : nullptr;
    }
  }
  const uint32_t ring_s = sg::smem_u32(ring);

  auto load = [&](int kc, int stage) {
    const uint32_t st = ring_s + stage * R::kStageBytes;
    const int k0 = kc * kBK;
    const bool kin = k0 + c * 8 < K;
#pragma unroll
    for (int j = 0; j < kACopies; ++j) {
      const int r = r0 + 32 * j;
      const bool aok = kin && r < arows;
      sg::cp_async16(st + sg::swz(r, c), aok ? a + r * lda + c * 8 + k0 : a,
                     aok);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (kGates) {
        const int kr = bk + 16 * j;
        const bool bok = bsrc[j] != nullptr && k0 + kr < K;
        sg::cp_async16(st + R::kABytes + attn_dwv::mn_off(kr, bq),
                       bok ? bsrc[j] + k0 * bld : a, bok);
      } else {
        const int r = r0 + 32 * j;
        const bool bok = kin && bsrc[j] != nullptr;
        sg::cp_async16(st + R::kABytes + sg::swz(r, c),
                       bok ? bsrc[j] + k0 : a, bok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < R::kAhead; ++s) {
    if (s < nk) load(s, s);
    sg::cp_async_commit();
  }
  int stage = 0;          // the stage of chunk kc
  int ahead = R::kAhead;  // the stage of chunk kc + kAhead
  for (int kc = 0; kc < nk; ++kc) {
    sg::cp_async_wait<R::kAhead - 1>();  // this thread's copies of chunk kc
    sg::fence_proxy_async();
    __syncthreads();
    const uint32_t st = ring_s + stage * R::kStageBytes;
    const uint32_t bs = st + R::kABytes;
#pragma unroll
    for (int u = 0; u < kSub; ++u) sg::fence_acc(acc[u]);
    sg::wgmma_fence();
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const uint32_t as =
          st + ((t >> 7) * (BM / 2) + 64 * u) * sg::kRowBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        if constexpr (kGates) {
          wgmma_kmn<E>(acc[u], sg::desc(as + kk * 32),
                       attn_dwv::desc_mn(bs + kk * 2048), (kc | kk) != 0);
        } else {
          sg::mma<kN, 0, E>(acc[u], sg::desc(as + kk * 32),
                            sg::desc(bs + kk * 32), (kc | kk) != 0);
        }
      }
    }
    sg::wgmma_commit();
#pragma unroll
    for (int u = 0; u < kSub; ++u) sg::fence_acc(acc[u]);
    sg::wgmma_wait<1>();
#pragma unroll
    for (int u = 0; u < kSub; ++u) sg::fence_acc(acc[u]);
    if (kc + R::kAhead < nk) load(kc + R::kAhead, ahead);
    sg::cp_async_commit();
    stage = stage + 1 == R::kStages ? 0 : stage + 1;
    ahead = ahead + 1 == R::kStages ? 0 : ahead + 1;
  }
  sg::wgmma_wait<0>();
#pragma unroll
  for (int u = 0; u < kSub; ++u) sg::fence_acc(acc[u]);
  sg::cp_async_wait<0>();
  if (nk == 0) {
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[u][i] = 0.0f;
  }
}

// A BM x 128 tile's accumulators (tile_gemm's) into Cs [BM][kCLd] f32,
// after a barrier that frees the ring they reuse; ends with a barrier.
template <int BM>
__device__ __forceinline__ void tile_to_smem(
    const float (&acc)[BM / 128][kN / 2], float* Cs) {
  __syncthreads();
  const int t = threadIdx.x;
  const int row = (t >> 7) * (BM / 2) + ((t >> 5) & 3) * 16 + ((t & 31) >> 2);
  const int col = score_gemm::frag_col(t);
#pragma unroll
  for (int u = 0; u < BM / 128; ++u)
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(Cs + (row + 64 * u + 8 * h) * kCLd +
                                   8 * j + col) =
            make_float2(acc[u][4 * j + 2 * h], acc[u][4 * j + 2 * h + 1]);
  __syncthreads();
}

// One step of the forward: h' = cell(gx, gh, h_prev) where t < lens[b].
// Blocks (2 jx + h, by, d) form a cluster of two: block h takes half h of
// gh's K (the state's units 64-aligned halves) for the tile's 256 rows
// and 40 units, and after the cluster's barrier applies the cell to rows
// 128 h .. 128 h + 127 with gh = P_0 + P_1 (both halves' sums, the
// peer's read from its shared memory).
template <class E>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
gru_wide_fwd_kernel(Fwd<E> d0, Fwd<E> d1, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = score_gemm::align1024(smem);
  float* Cs = reinterpret_cast<float*>(ring);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int half = static_cast<int>(cluster.block_rank());
  const Fwd<E> p = blockIdx.z == 0 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int t = p.reverse ? p.T - 1 - k : k;
  const int j0 = (blockIdx.x >> 1) * kUnits;
  const int b0 = blockIdx.y * kTall;
  const float* hf =
      k == 0 ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * BH;
  const float* x = p.gx + static_cast<size_t>(t) * B * H3;
  // Thread: units j, j + 1 (pair t % 20) of rows t / 20 + 12 m, 4 rows at
  // a time: their operands loaded at once (the first 4 rows' before the
  // product, each next 4's before the cell of the 4 before them), then
  // the sums, then the cell.
  constexpr int kPairs = kUnits / 2;
  constexpr int kLanes = kThreads / kPairs;  // 12 rows at a time
  const int i = 2 * (threadIdx.x % kPairs);
  const int r0 = threadIdx.x / kPairs;
  const int j = j0 + i;
  const int rb = b0 + kRows * half;  // this block's rows
  const bool active = r0 < kLanes && j < H;
  struct Ops {
    float2 xr[4], xz[4], xn[4], hp[4];
    bool live[4];
  };
  auto load = [&](int m0, Ops& v) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + kLanes * (m0 + u);
      const int b = rb + r;
      v.live[u] = false;
      v.xr[u] = v.xz[u] = v.xn[u] = v.hp[u] = make_float2(0.0f, 0.0f);
      if (r >= kRows || b >= B) continue;
      const float2* xb = reinterpret_cast<const float2*>(x + b * H3 + j);
      v.xr[u] = __ldg(xb);
      v.xz[u] = __ldg(xb + H / 2);
      v.xn[u] = __ldg(xb + H);
      if (hf != nullptr)
        v.hp[u] = *reinterpret_cast<const float2*>(
            hf + static_cast<size_t>(b) * H + j);
      v.live[u] = t < __ldg(p.lens + b);
    }
  };
  Ops v[2];
  if (active) load(0, v[0]);

  const float* P[2] = {Cs, Cs};
  // At the first step the state is zero: gh = 0, no product.
  if (k > 0) {
    const int kh = (H + 2 * kBK - 1) / (2 * kBK) * kBK;  // K of half 0
    const int kb = half * kh;
    float acc[2][kN / 2];
    tile_gemm<kTall, E>(
        p.hbf + ((k + 1) & 1) * BH + static_cast<size_t>(b0) * H + kb, H,
        B - b0, GateColumns<E>{p.uh + kb * H3, H, j0}, min(H, kb + kh) - kb,
        ring, acc);
    tile_to_smem<kTall>(acc, Cs);
    cluster.sync();  // both halves' sums are in shared memory
    P[1 - half] = cluster.map_shared_rank(Cs, 1 - half);  // the peer's
  }
  float* ho = p.hseq + t * BH;
  E* hbo = p.hbf + (k & 1) * BH;
  float* hTo = k == p.T - 1 ? p.hT : nullptr;
  using Pair = typename Elem<E>::pair;
  const float2 bhn = active ? *reinterpret_cast<const float2*>(p.bhn + j)
                            : make_float2(0.0f, 0.0f);
  auto sum2 = [](float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
  };
  auto run = [&](int m0, const Ops& v) {
    float2 gh[3][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + kLanes * (m0 + u);
#pragma unroll
      for (int g = 0; g < 3; ++g) gh[g][u] = make_float2(0.0f, 0.0f);
      if (k == 0 || r >= kRows) continue;
      const int c = (kRows * half + r) * kCLd + i;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const int cg = c + g * kUnits;
        gh[g][u] = sum2(*reinterpret_cast<const float2*>(P[0] + cg),
                        *reinterpret_cast<const float2*>(P[1] + cg));
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + kLanes * (m0 + u);
      const int b = rb + r;
      if (r >= kRows || b >= B) continue;
      float h[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xr = e ? v.xr[u].y : v.xr[u].x;
        const float xz = e ? v.xz[u].y : v.xz[u].x;
        const float xn = e ? v.xn[u].y : v.xn[u].x;
        const float hp = e ? v.hp[u].y : v.hp[u].x;
        const float ghr = e ? gh[0][u].y : gh[0][u].x;
        const float ghz = e ? gh[1][u].y : gh[1][u].x;
        const float ghn = e ? gh[2][u].y : gh[2][u].x;
        const float rg = wsigmoid(__fadd_rn(xr, ghr));
        const float zg = wsigmoid(__fadd_rn(xz, ghz));
        const float ng = tanhf(
            __fadd_rn(xn, __fmul_rn(rg, __fadd_rn(ghn, e ? bhn.y : bhn.x))));
        const float hn = __fadd_rn(__fmul_rn(1.0f - zg, ng), __fmul_rn(zg, hp));
        h[e] = v.live[u] ? hn : hp;
      }
      const size_t o = static_cast<size_t>(b) * H + j;
      const float2 hv = make_float2(h[0], h[1]);
      *reinterpret_cast<float2*>(ho + o) = hv;
      *reinterpret_cast<Pair*>(hbo + o) = Elem<E>::from2(h[0], h[1]);
      if (hTo != nullptr) *reinterpret_cast<float2*>(hTo + o) = hv;
    }
  };
  if (active) {
    constexpr int kBatches = (kRows + 4 * kLanes - 1) / (4 * kLanes);
#pragma unroll
    for (int s = 0; s < kBatches; ++s) {
      if (s + 1 < kBatches) load(4 * (s + 1), v[(s + 1) & 1]);
      run(4 * s, v[s & 1]);
    }
  }
  if (k > 0) cluster.sync();  // the peer has read this block's sums
}

// The E copy of the pre-step states: hseq[0..T-2] (forward) or
// hseq[1..T-1] (reverse), rounded as the plain version rounds h_prev, into
// rows of Hq values (zero past H); and zeros in G's units that no carry
// tile covers. blockIdx.y picks the direction. H % 4 == 0.
template <class E>
__global__ void __launch_bounds__(kThreads)
gru_wide_round_kernel(Bwd<E> d0, Bwd<E> d1) {
  const Bwd<E> p = blockIdx.y == 0 ? d0 : d1;
  const size_t first = p.reverse ? p.B : 0;  // row of the first saved state
  const float* src = p.hseq + first * p.H;
  using Pair = typename Elem<E>::pair;
  Pair* dst = reinterpret_cast<Pair*>(p.hbf + first * p.Hq);
  const int q4 = p.Hq / 4;
  const size_t n4 = static_cast<size_t>(p.T - 1) * p.B * q4;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t m = i / q4;
    const int c = 4 * static_cast<int>(i - m * q4);
    const float4 h = c < p.H ? __ldg(reinterpret_cast<const float4*>(
                                   src + m * p.H + c))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    dst[2 * i] = Elem<E>::from2(h.x, h.y);
    dst[2 * i + 1] = Elem<E>::from2(h.z, h.w);
  }
  // G's units from the carry's last tile on, which no carry writes: zero.
  const int hc = (p.H + kCarryUnits - 1) / kCarryUnits * kCarryUnits;
  const int band = p.Hq - hc;
  const size_t nz = static_cast<size_t>(p.T) * p.B * 3 * band;
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < nz; i += static_cast<size_t>(gridDim.x) * kThreads) {
    const size_t row = i / band;  // (t, b, gate)
    p.g[row * p.Hq + hc + (i - row * band)] = Elem<E>::from(0.0f);
  }
}

// Every step's gh = E(h_prev) @ U_h at once: the (T-1) B saved states (the
// rows of the E copy from hbf's first pre-step state on) by U_h's gate
// columns, written to dgx's buffer at the states' own rows. Block (jx, by,
// d) takes the r, z and n columns of units 40 jx.. for saved states
// 256 by...
template <class E>
__global__ void __launch_bounds__(kThreads, 1)
gru_wide_gh_kernel(Bwd<E> d0, Bwd<E> d1) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = score_gemm::align1024(smem);
  float* Cs = reinterpret_cast<float*>(ring);
  const Bwd<E> p = blockIdx.z == 0 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int M = (p.T - 1) * B;
  const int m0 = blockIdx.y * kTall;
  if (m0 >= M) return;  // T = 1: no saved state
  const size_t first = p.reverse ? B : 0;  // row of the first saved state
  const int j0 = blockIdx.x * kUnits;
  float acc[2][kN / 2];
  tile_gemm<kTall, E>(p.hbf + (first + m0) * p.Hq, p.Hq, M - m0,
                      GateColumns<E>{p.uh, H, j0}, H, ring, acc);
  tile_to_smem<kTall>(acc, Cs);
  float* gh = p.dgx + (first + m0) * H3;
  for (int e = threadIdx.x; e < kTall * 3 * kUnits; e += kThreads) {
    const int r = e / (3 * kUnits);
    const int c = e - r * (3 * kUnits);
    const int g = c / kUnits;
    const int j = j0 + c - g * kUnits;
    if (m0 + r < M && j < H) gh[r * H3 + g * H + j] = Cs[r * kCLd + c];
  }
}

// Step k of the BPTT (t from the chain's end). Block (jx, by, 3 d + g) of
// a cluster of three: with k > 0 the product of gate g, G_{t'}[:, g] U_g^T
// for units 128 jx.. and rows 128 by.. (t' the step processed before),
// then dh for the tile = ((dpart + P_r) + P_z) + P_n, read from the three
// blocks' shared memory; with k = 0, dh = dpart (the final state's
// cotangent). Then this step's gate backward for the tile's 16-row groups
// q with q % 3 == g.
template <class E>
__global__ void __cluster_dims__(1, 1, 3) __launch_bounds__(kThreads, 1)
gru_wide_carry_kernel(Bwd<E> d0, Bwd<E> d1, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float Rs[3][4][kCarryUnits];  // dgh_n quarter-group sums
  unsigned char* ring = score_gemm::align1024(smem);
  float* Cs = reinterpret_cast<float*>(ring);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int g = static_cast<int>(cluster.block_rank());
  const Bwd<E> p = blockIdx.z < 3 ? d0 : d1;
  const int H = p.H;
  const int B = p.B;
  const int T = p.T;
  const size_t BH = static_cast<size_t>(B) * H;
  const size_t H3 = 3 * static_cast<size_t>(H);
  const int t = p.reverse ? k : T - 1 - k;
  const bool first = p.reverse ? t == T - 1 : t == 0;  // zero h_prev
  const size_t tp = static_cast<size_t>(p.reverse ? t + 1 : t - 1);
  const int j0 = blockIdx.x * kCarryUnits;
  const int b0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;

  // Thread: units jl, jl + 1 (pair tid % 64) of rows 4 qt .. 4 qt + 3
  // (qt = tid / 64) of each of the rank's 16-row groups, in order.
  const int jl = 2 * (tid & 63);
  const int qt = tid >> 6;
  const int j = j0 + jl;
  const bool unit = j < H;  // H % 16 == 0: so is j + 1
  const float* hf = first ? nullptr : p.hseq + tp * BH;
  const float* ghs = first ? nullptr : p.dgx + tp * B * H3;
  const float* gxt = p.gx + static_cast<size_t>(t) * B * H3;
  float* dgxt = p.dgx + static_cast<size_t>(t) * B * H3;
  const size_t Hq3 = 3 * static_cast<size_t>(p.Hq);
  E* gt = p.g + static_cast<size_t>(t) * B * Hq3;
  using Pair = typename Elem<E>::pair;
  auto ld2 = [](const float* q) { return *reinterpret_cast<const float2*>(q); };
  // A 16-row group's operands for this thread's 4 rows of it, loaded at
  // once: the first group's before the product, so that they land while
  // it runs, each next group's before the gate backward of the one before.
  struct Ops {
    float2 dh[4], xr[4], xz[4], xn[4], ghr[4], ghz[4], ghn[4], hp[4];
    bool live[4];
  };
  auto load = [&](int q, Ops& v) {
    const float2 zero = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + q * 16 + qt * 4 + i;
      v.dh[i] = v.xr[i] = v.xz[i] = v.xn[i] = zero;
      v.ghr[i] = v.ghz[i] = v.ghn[i] = v.hp[i] = zero;
      v.live[i] = false;
      if (b >= B || !unit) continue;
      const size_t o = static_cast<size_t>(b) * H + j;
      const size_t ob = b * H3 + j;
      v.dh[i] = ld2(p.dpart + o);
      v.xr[i] = __ldg(reinterpret_cast<const float2*>(gxt + ob));
      v.xz[i] = __ldg(reinterpret_cast<const float2*>(gxt + ob + H));
      v.xn[i] = __ldg(reinterpret_cast<const float2*>(gxt + ob + 2 * H));
      if (!first) {
        v.ghr[i] = ld2(ghs + ob);
        v.ghz[i] = ld2(ghs + ob + H);
        v.ghn[i] = ld2(ghs + ob + 2 * H);
        v.hp[i] = __ldg(reinterpret_cast<const float2*>(hf + o));
      }
      v.live[i] = t < __ldg(p.lens + b);
    }
  };
  Ops v[2];
  load(g, v[0]);

  const float* P[3] = {Cs, Cs, Cs};
  if (k > 0) {
    const int tq = p.reverse ? t - 1 : t + 1;  // the step processed before
    const E* gq = p.g + static_cast<size_t>(tq) * B * Hq3;
    float acc[1][kN / 2];
    tile_gemm<kRows, E>(gq + static_cast<size_t>(b0) * Hq3 + g * p.Hq, Hq3,
                        B - b0,
                        Rows<E>{p.uh + static_cast<size_t>(j0) * H3 + g * H,
                                H3, H - j0},
                        H, ring, acc);
    tile_to_smem<kRows>(acc, Cs);
    cluster.sync();  // the three products are in shared memory
#pragma unroll
    for (int r = 0; r < 3; ++r)
      if (r != g) P[r] = cluster.map_shared_rank(Cs, r);
  }

  const float2 bhn = unit ? ld2(p.bhn + j) : make_float2(0.0f, 0.0f);
  // The gate backward of group q's 4 rows x 2 units from v; their dgh_n
  // summed, row by row, into Rs[slot][qt].
  auto run = [&](int q, const Ops& v, int slot) {
    float2 dsum[4];  // dh, read for all 4 rows before their gate backward
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dsum[i] = v.dh[i];
      if (k > 0) {
        const int c = (q * 16 + qt * 4 + i) * kCLd + jl;
        float2 pr[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) pr[r] = ld2(P[r] + c);
        dsum[i].x = __fadd_rn(__fadd_rn(__fadd_rn(dsum[i].x, pr[0].x),
                                        pr[1].x), pr[2].x);
        dsum[i].y = __fadd_rn(__fadd_rn(__fadd_rn(dsum[i].y, pr[0].y),
                                        pr[1].y), pr[2].y);
      }
    }
    float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + q * 16 + qt * 4 + i;
      if (b >= B) continue;
      E* go = gt + b * Hq3 + j;
      if (!unit) {  // G's padding units: zero for dU_h's tiles
        const Pair z = Elem<E>::from2(0.0f, 0.0f);
        *reinterpret_cast<Pair*>(go) = z;
        *reinterpret_cast<Pair*>(go + p.Hq) = z;
        *reinterpret_cast<Pair*>(go + 2 * p.Hq) = z;
        continue;
      }
      float out[5][2];  // da_r, da_z, da_n, dgh_n, dhp of both units
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const auto pick = [e](float2 w) { return e ? w.y : w.x; };
        const float d = pick(dsum[i]);
        const float ghn_b = __fadd_rn(pick(v.ghn[i]), e ? bhn.y : bhn.x);
        const float r = wsigmoid(__fadd_rn(pick(v.xr[i]), pick(v.ghr[i])));
        const float z = wsigmoid(__fadd_rn(pick(v.xz[i]), pick(v.ghz[i])));
        const float n =
            tanhf(__fadd_rn(pick(v.xn[i]), __fmul_rn(r, ghn_b)));
        const float m = v.live[i] ? 1.0f : 0.0f;
        const float dh_new = __fmul_rn(m, d);
        const float dhp =
            __fadd_rn(__fmul_rn(1.0f - m, d), __fmul_rn(dh_new, z));
        const float dz = __fmul_rn(dh_new, pick(v.hp[i]) - n);
        const float dn = __fmul_rn(dh_new, 1.0f - z);
        const float da_n = __fmul_rn(dn, 1.0f - __fmul_rn(n, n));
        out[0][e] = __fmul_rn(__fmul_rn(__fmul_rn(da_n, ghn_b), r), 1.0f - r);
        out[1][e] = __fmul_rn(__fmul_rn(dz, z), 1.0f - z);
        out[2][e] = da_n;
        out[3][e] = __fmul_rn(da_n, r);  // dgh_n
        out[4][e] = dhp;
      }
      const size_t ob = b * H3 + j;
      float2* dg = reinterpret_cast<float2*>(dgxt + ob);
      dg[0] = make_float2(out[0][0], out[0][1]);
      dg[H / 2] = make_float2(out[1][0], out[1][1]);
      dg[H] = make_float2(out[2][0], out[2][1]);
      *reinterpret_cast<Pair*>(go) = Elem<E>::from2(out[0][0], out[0][1]);
      *reinterpret_cast<Pair*>(go + p.Hq) =
          Elem<E>::from2(out[1][0], out[1][1]);
      *reinterpret_cast<Pair*>(go + 2 * p.Hq) =
          Elem<E>::from2(out[3][0], out[3][1]);
      *reinterpret_cast<float2*>(p.dpart + static_cast<size_t>(b) * H + j) =
          make_float2(out[4][0], out[4][1]);
      s.x += out[3][0];
      s.y += out[3][1];
    }
    Rs[slot][qt][jl] = s.x;
    Rs[slot][qt][jl + 1] = s.y;
  };
  constexpr int kGroups = kRows / 16;
#pragma unroll
  for (int slot = 0; slot < 3; ++slot) {
    const int q = g + 3 * slot;
    if (q >= kGroups) break;
    if (q + 3 < kGroups) load(q + 3, v[(slot + 1) & 1]);
    run(q, v[slot & 1], slot);
  }
  __syncthreads();
  if (tid < kCarryUnits && j0 + tid < H) {  // the block's dgh_n, in order
    float sum = 0.0f;
    for (int slot = 0; g + 3 * slot < kGroups; ++slot)
      for (int qq = 0; qq < 4; ++qq) sum += Rs[slot][qq][tid];
    const size_t parts = 3 * static_cast<size_t>(gridDim.y);
    p.part[(k * parts + 3 * blockIdx.y + g) * H + j0 + tid] = sum;
  }
  if (k > 0) cluster.sync();  // the other ranks have read this block's Cs
}

// The forwards p[0..dirs-1] on `st`: T launches of gru_wide_fwd_kernel,
// each advancing every direction by one step. Counts in *launched the
// kernels that launched; returns the first CUDA error (cleared from the
// runtime).
template <class E>
int fwd_run(const Fwd<E> (&p)[2], int dirs, cudaStream_t st,
            int* launched) {
  *launched = 0;
  const int T = p[0].T;
  const int B = p[0].B;
  const int H = p[0].H;
  cudaError_t e = cudaSuccess;
  if (T < 1 || B < 1 || H < 16 || H % 16 != 0 || dirs < 1 || dirs > 2)
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_fwd_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  const dim3 grid(2 * ((H + kUnits - 1) / kUnits), (B + kTall - 1) / kTall,
                  dirs);
  for (int k = 0; e == cudaSuccess && k < T; ++k) {
    gru_wide_fwd_kernel<E><<<grid, kThreads, kSmem, st>>>(p[0], p[1], k);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// The BPTTs p[0..dirs-1] on `st`: the E copy of the pre-step states, every
// step's gh, one carry launch a step (the first without a product), then
// the dU_h product of each direction and gru_bwd_step.cuh's db_hn sum of
// every direction: T + 3 + dirs launches. duh[d] ([H, 3H] f32) and dbhn[d]
// ([H] f32) are direction d's: duh[d] [Hq, 3Hq] f32, gate blocks of Hq (the
// rows and columns past H are the padding's). p[d].dpart holds the
// cotangent of the final state on entry and is clobbered. H % 16 == 0 and
// Hq = H rounded up to 128. Counts in *launched the kernels that launched;
// returns the first CUDA error (cleared from the runtime).
template <class E>
int bwd_run(const Bwd<E> (&p)[2], float* const (&duh)[2],
            float* const (&dbhn)[2], int dirs, cudaStream_t st,
            int* launched) {
  *launched = 0;
  const int T = p[0].T;
  const int B = p[0].B;
  const int H = p[0].H;
  cudaError_t e = cudaSuccess;
  if (T < 1 || B < 1 || H < 16 || H % 16 != 0 ||
      p[0].Hq != duh_width(H) || dirs < 1 || dirs > 2)
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_gh_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gru_wide_carry_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const int Hq = p[0].Hq;
  const size_t n4 = static_cast<size_t>(T - 1) * B * Hq / 4;
  const int rblocks = static_cast<int>(std::max<size_t>(
      1, std::min<size_t>((n4 + kThreads - 1) / kThreads, 4096)));
  gru_wide_round_kernel<E><<<dim3(rblocks, dirs), kThreads, 0, st>>>(p[0],
                                                                    p[1]);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    ++*launched;
    const int M = (T - 1) * B;
    const dim3 grid((H + kUnits - 1) / kUnits,
                    std::max(1, (M + kTall - 1) / kTall), dirs);
    gru_wide_gh_kernel<E><<<grid, kThreads, kSmem, st>>>(p[0], p[1]);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) ++*launched;
  const dim3 grid((H + kCarryUnits - 1) / kCarryUnits,
                  (B + kRows - 1) / kRows, 3 * dirs);
  for (int k = 0; e == cudaSuccess && k < T; ++k) {
    gru_wide_carry_kernel<E><<<grid, kThreads, kSmem, st>>>(p[0], p[1], k);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  // dU_h = sum over the saved states of E(h_prev)^T G: attention_dwv.cuh's
  // dW_v product, whose reduction runs along the rows of both operands
  // (the cells there, the (step, row) pairs here), one launch a direction
  // with the rows unsplit, so its tiles write dU_h. h_prev of step t is
  // hseq[t-1] (forward) or hseq[t+1] (reverse); the first processed step's
  // zero state adds nothing and is left out.
  for (int d = 0; e == cudaSuccess && d < dirs; ++d) {
    const size_t first = p[d].reverse ? 0 : B;  // G's row of the first state
    e = attn_dwv::launch_dwv(
        attn_dwv::DenseCells<E>{p[d].hbf + (B - first) * Hq, Hq},
        p[d].g + first * 3 * Hq, duh[d], (T - 1) * B, Hq, 3 * Hq, 1, st);
    if (e == cudaSuccess) ++*launched;
  }
  if (e == cudaSuccess) {
    const int parts = 3 * ((B + kRows - 1) / kRows);
    gru_dbhn_kernel<<<dim3((H + 255) / 256, dirs), 256, 0, st>>>(
        DbhnSum{p[0].part, dbhn[0]}, DbhnSum{p[1].part, dbhn[1]}, T * parts,
        H);
    e = cudaGetLastError();
    if (e == cudaSuccess) ++*launched;
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

// The carry launch's clusters that the card can hold at once (0 where
// none fits), for the report: cudaOccupancyMaxActiveClusters at the carry
// grid of (B, H) with `dirs` directions.
template <class E>
int carry_clusters(int B, int H, int dirs, int* clusters) {
  *clusters = 0;
  cudaError_t e = cudaFuncSetAttribute(
      gru_wide_carry_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((H + kCarryUnits - 1) / kCarryUnits,
                       (B + kRows - 1) / kRows, 3 * dirs);  // Hq / 128
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    e = cudaOccupancyMaxActiveClusters(clusters, gru_wide_carry_kernel<E>,
                                       &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace wide
}  // namespace
