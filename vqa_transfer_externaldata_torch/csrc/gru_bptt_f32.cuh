// gru_bptt_f32.cuh: the step form of the float32 GRU's BPTT, K3f's
// (csrc/gru_bwd_f32.cu, gru_bwd_f32_step) and K7f's (csrc/bigru_bwd_f32.cu,
// bigru_bwd_f32_step, both chains in each launch, the chain on blockIdx.z),
// taken where the persistent chain of gru_seq_f32.cuh does not fit (past
// ~1000 units on an H100). For Hopper (sm_90a).
//
// What bounds it: at B = 256, T = 26, H = 2400 each chain's three products
// (every step's gh, the carried dh through U_h^T, dU_h) are 2 x 2400 x 7200
// FLOP a row-step over the row-steps that are live, about half of the T B
// at lengths uniform in 1..T: ~110 GFLOP each, 1.7 ms each at the FP32
// pipes' 67 TFLOP/s. The carry's T dependent steps are the hard part: a
// step's output is at most B x H = 256 x 2400 sums against 132 SMs, each
// sum one FFMA chain over 3H = 7200 k (no split-K: the bits are fixed), and
// it falls as rows die.
//
// Design, launches in stream order (launch_step_form):
//  1. gru_f32_lists_kernel, one block a step: the live rows of step t
//     (t < lens[b]) in ascending b, then the dead ones, and their count;
//     the packed list of the live row-steps whose h_prev is not zero, one
//     list for both chains (StepLists). Nothing is read back to the host
//     and no grid is sized from it, so the call stays capturable in a CUDA
//     graph.
//  2. every step's gh = h_prev @ U_h over those row-steps only, on
//     fp32_ring.cuh's loop through the list (gru_seq_f32.cuh,
//     gru_f32_gh_kernel), each row written to its own place: off the chain.
//  3. one launch a step, gru_f32_carry_kernel: dh_t = dpart + g_{t+-1} @
//     U_h^T for the rows live at step t only (the walk's first step: dpart
//     as it stands, the cotangent of hT), and the gate backward of step t
//     on the same elements in its epilogue (gru_step_f32.cuh's cell_bwd,
//     from gh_t, gx_t and h_prev): dgx_t, g_t and dpart. A block owns BU =
//     4 TU units of one chain (blockIdx.z) for every live row of the step,
//     so the blocks' work falls together as rows die and no block waits
//     on another: TU = 5 at 2400 units, 120 blocks a chain, two blocks an
//     SM, so K7f's blocks of its two chains (the one short of rows where
//     the other is full) share the SMs. Its 128 threads keep TRN x TU sums
//     (rows ty + 32 i, units tx + 4 e) over passes of 256 list positions,
//     TRN the fewest rows a thread that the pass needs (1 .. 8). The
//     products are bound by shared-memory loads: an SM moves 128 bytes a
//     cycle into registers, a 128-bit load of a warp takes 4 of them
//     whatever it broadcasts, and a thread loads TRN + TU floats for TRN TU
//     FFMA, so few threads hold a large tile (8 x 5: 0.33 floats an FFMA
//     against the FP32 pipes' 0.25). The operands stream through a
//     cp.async ring of 32-k chunks, 2 stages of a whole pass and more of a
//     pass of fewer rows (10 at 32): g's rows (through the step's list, rows
//     dead at the previous walked step zero-filled, not read) and the
//     block's BU rows of U_h, each thread's copy rows held in registers,
//     both read as 128-bit k-quads from rows padded to 36 floats, so a
//     quarter warp's 2 rows of A and 4 units of U_h fall in distinct bank
//     groups. Rows dead at step t keep their dpart; the block writes zeros
//     into their dgx_t and g_t columns (each dead (t, b) once a call).
//  4. dU_h = h_prev^T g over the same row-steps, through the same lists, on
//     fp32_ring.cuh's loop (gru_seq_f32.cuh, gru_f32_duh_kernel);
//  5. db_hn, the column sums of g's n-gate block (gru_step_f32.cuh).
// T + 4 launches a call, one chain or two.
//
// Bits: every sum is one FFMA chain, k ascending from a zero start, as the
// persistent form's and the parent step form's; a row-step left out is one
// whose g row is +-0 or whose h_prev is 0, which adds nothing to a sum that
// is never -0 (and whose gh, 0 read for a sum of zeros, is +0). So each
// output equals the persistent form's bit for bit (dgx's dead rows +0 where
// a gate backward of a dead row gave +-0). No atomics: two calls give the
// same bits.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

#include "fp32_ring.cuh"
#include "gru_seq_f32.cuh"
#include "gru_step_f32.cuh"

namespace gru_bptt_f32 {

// The step lists in one int32 buffer of T B + T + max(T - 1, 1) B + 1
// ints (ops/kernels.py::gru_f32_lists_ints): rows [T][B] (step t's live
// rows in ascending b, then its dead ones), cnt [T] (the live rows a
// step), the packed row-steps [max(T - 1, 1) B] and their count m [1]:
// (t - 1) B + b for every b live at step t = 1 .. T - 1, in that order.
// They are the forward chain's row-steps of step t, whose h_prev hseq[t -
// 1] is not the zero start, and the reverse chain's of step t - 1 that a
// row live at step t makes, whose h_prev hseq[t] is not zero (at a row's
// first reverse step, t = lens - 1, h_prev is the zero state it carried
// through its dead steps). Both chains read them as indices r B + b of
// their saved states.
template <class I>
struct StepLists {
  I* rows;
  I* cnt;
  I* rowsteps;
  I* m;
  __host__ __device__ static StepLists at(I* base, int T, int B) {
    StepLists l;
    l.rows = base;
    l.cnt = l.rows + static_cast<long long>(T) * B;
    l.rowsteps = l.cnt + T;
    l.m = l.rowsteps + static_cast<long long>(T > 1 ? T - 1 : 1) * B;
    return l;
  }
};

constexpr int LIST_THREADS = 256;

// Step t = blockIdx.x's lists from lens [B]: every block sums what it needs
// of the others' counts (pre[t] = sum_b clamp(lens[b], 0, t)), then ranks
// its rows with a block-wide scan, LIST_THREADS rows a round.
__global__ void __launch_bounds__(LIST_THREADS)
    gru_f32_lists_kernel(const int* __restrict__ lens, int* __restrict__ buf,
                         int T, int B) {
  constexpr int NW = LIST_THREADS / 32;
  __shared__ int red[4][NW];
  __shared__ int wcount[NW];
  const StepLists<int> L = StepLists<int>::at(buf, T, B);
  const int t = blockIdx.x;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int sums[4] = {0, 0, 0, 0};  // pre[t], cnt[t], cnt[0], pre[T]
  for (int b = threadIdx.x; b < B; b += LIST_THREADS) {
    const int l = max(__ldg(lens + b), 0);
    sums[0] += min(l, t);
    sums[1] += l > t;
    sums[2] += l > 0;
    sums[3] += min(l, T);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      sums[q] += __shfl_xor_sync(0xffffffffu, sums[q], o);
    if (lane == 0) red[q][warp] = sums[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sums[q] = 0;
    for (int w = 0; w < NW; ++w) sums[q] += red[q][w];
  }
  const int pre = sums[0], n = sums[1], n0 = sums[2];
  if (threadIdx.x == 0) {
    L.cnt[t] = n;
    if (t == T - 1) L.m[0] = sums[3] - n0;  // the row-steps of 1 .. T - 1
  }
  int live_before = 0, dead_before = 0;
  int* rows = L.rows + static_cast<long long>(t) * B;
  for (int b0 = 0; b0 < B; b0 += LIST_THREADS) {
    const int b = b0 + threadIdx.x;
    const bool in = b < B, live = in && __ldg(lens + b) > t;
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    const int within = __popc(ballot & ((1u << lane) - 1u));
    __syncthreads();  // the last round's counts are read
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < NW; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    const int rank = before + within;  // live rows of the round before b
    if (live) {
      const int j = live_before + rank;
      rows[j] = b;
      if (t >= 1) L.rowsteps[pre - n0 + j] = (t - 1) * B + b;
    } else if (in) {
      rows[n + dead_before + threadIdx.x - rank] = b;
    }
    live_before += total;
    dead_before += min(LIST_THREADS, B - b0) - total;
  }
}

constexpr int THREADS = 128;
constexpr int UL = 4;             // unit lanes: a block's units tx + 4 e
constexpr int RG = THREADS / UL;  // row groups: a pass's rows ty + 32 i
constexpr int TR = 8;             // rows a thread at most
constexpr int RB = RG * TR;       // list positions a pass
constexpr int KC = 32;            // k a ring stage
constexpr int S = 2;              // stages of a whole pass
constexpr int P = KC + 4;         // floats a staged row
constexpr int MAX_TU = 5;         // units a thread at most
constexpr int RING = S * (RB + UL * MAX_TU) * P;  // the ring's floats

// The carry's dynamic shared memory: the pass's row pointers [RB], then
// the ring: S stages of [RB + 4 MAX_TU][P] floats (g's rows, then U_h's);
// two blocks an SM.
__host__ __device__ constexpr int carry_smem() { return RB * 8 + RING * 4; }

// The stages of a pass of ROWS rows: as many of [ROWS + 4 MAX_TU][P] as
// the ring holds (2 at 256 rows, 10 at 32), so a pass of few rows keeps as
// many bytes in flight as a whole one.
__host__ __device__ constexpr int stages(int rows) {
  return RING / ((rows + UL * MAX_TU) * P);
}

// One chain's inputs and outputs of a step-form call.
struct Chain {
  const float* gx;    // [T, B, 3H]
  const float* hseq;  // [T, B, H]
  const float* uh;    // [H, 3H]
  const float* bhn;   // [H]
  float* dpart;       // [B, H]: the cotangent of hT on entry, scratch
  float* gh;          // [max(T - 1, 1) B, 3H] scratch
  float* gq;          // [T, B, 3H] scratch
  float* dgx;         // [T, B, 3H]
  float* duh;         // [H, 3H]
  float* dbhn;        // [H]
  int reverse;
};

struct CarryArgs {
  Chain c[2];        // chain z of the launch, c[1] = c[0] for K3f
  const int* lens;   // [B]
  const int* lists;  // StepLists
  int s, T, B, H;
};

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// The pass's products: acc[i][e] += sum over k = 0 .. 3H - 1 of g row
// rptr[ty + RG i] (zero where null) times U_h's row u0 + tx + UL e, one
// FFMA chain a sum, k ascending, TRN rows a thread. Thread tid copies the
// k-quad (tid % Q) of rows tid / Q + (THREADS / Q) c of g and of U_h,
// whose row pointers it holds in registers.
template <int TRN, int TU, bool V16>
__device__ __forceinline__ void carry_products(
    const float* const* rptr, const float* __restrict__ uh, int H, int u0,
    float* ring, float (&acc)[TR][TU]) {
  constexpr int BU = UL * TU, ROWS = TRN * RG, Q = KC / 4;
  constexpr int CPR = THREADS / Q;  // rows a round of copies
  constexpr int NA = ROWS / CPR, NU = (BU + CPR - 1) / CPR;
  constexpr int STAGE = (ROWS + UL * MAX_TU) * P, NS = stages(ROWS);
  static_assert(NS >= S && NS * STAGE <= RING, "the ring holds the stages");
  static_assert(ROWS % CPR == 0, "whole rounds of g's rows");
  const int K3 = 3 * H, nchunk = (K3 + KC - 1) / KC;
  const long long H3 = 3LL * H;
  const int tid = threadIdx.x, ty = tid / UL, tx = tid % UL;
  const int cr = tid / Q, cq = (tid % Q) * 4;
  const float* arow[NA];
  const float* urow[NU];
#pragma unroll
  for (int c = 0; c < NA; ++c) arow[c] = rptr[cr + CPR * c];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    const int uu = cr + CPR * c, u = u0 + uu;
    urow[c] = uu < BU && u < H ? uh + u * H3 : nullptr;
  }
  auto copy = [&](float* dst, const float* src, int k) {
    if constexpr (V16) {
      const bool ok = src != nullptr && k < K3;
      fp32_ring::cp_async<16>(dst, ok ? src + k : uh, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = src != nullptr && k + j < K3;
        fp32_ring::cp_async<4>(dst + j, ok ? src + k + j : uh, ok);
      }
    }
  };
  auto issue = [&](int c) {
    float* st = ring + (c % NS) * STAGE;
    const int k = c * KC + cq;
#pragma unroll
    for (int a = 0; a < NA; ++a)
      copy(st + (cr + CPR * a) * P + cq, arow[a], k);
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (cr + CPR * u < BU)
        copy(st + (ROWS + cr + CPR * u) * P + cq, urow[u], k);
  };
#pragma unroll 1
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nchunk) issue(c);
    fp32_ring::cp_async_commit();
  }
#pragma unroll 1
  for (int c = 0; c < nchunk; ++c) {
    fp32_ring::cp_async_wait<NS - 2>();
    __syncthreads();  // chunk c is whole; chunk c - 1's stage is free
    if (c + NS - 1 < nchunk) issue(c + NS - 1);
    fp32_ring::cp_async_commit();
    const float* st = ring + (c % NS) * STAGE;
    const float* As = st + ty * P;
    const float* Us = st + (ROWS + tx) * P;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float4 a[TRN], w[TU];
#pragma unroll
      for (int i = 0; i < TRN; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + RG * i * P + 4 * q);
#pragma unroll
      for (int e = 0; e < TU; ++e)
        w[e] = *reinterpret_cast<const float4*>(Us + UL * e * P + 4 * q);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TRN; ++i)
#pragma unroll
          for (int e = 0; e < TU; ++e)
            acc[i][e] = fmaf(lane(a[i], kk), lane(w[e], kk), acc[i][e]);
    }
  }
  fp32_ring::cp_async_wait<0>();
  __syncthreads();  // the ring and the row pointers are free
}

// A pass of trn rows a thread (1 .. TR): carry_products' instance for it.
template <int TU, int R = 1>
__device__ __forceinline__ void carry_pass(
    int trn, const float* const* rptr, const float* __restrict__ uh, int H,
    int u0, float* ring, float (&acc)[TR][TU]) {
  if (trn == R) {
    carry_products<R, TU, true>(rptr, uh, H, u0, ring, acc);
  } else if constexpr (R < TR) {
    carry_pass<TU, R + 1>(trn, rptr, uh, H, u0, ring, acc);
  }
}

// Step s of the walk of chain blockIdx.z (K3f: z 1; K7f: forward 0 at t =
// T - 1 - s, reverse 1 at t = s) for units u0 .. u0 + BU - 1 of the block:
// the carry and the gate backward of the rows live at step t, then zeros in
// the dead rows' dgx_t and g_t. Two blocks an SM, so K7f's blocks of the
// two chains (one mostly short of rows where the other is full) share one.
template <int TU, bool V16>
__global__ void __launch_bounds__(THREADS, 2)
    gru_f32_carry_kernel(CarryArgs a) {
  extern __shared__ __align__(16) unsigned char carry_smem_raw[];
  constexpr int BU = UL * TU;
  const int T = a.T, B = a.B, H = a.H, s = a.s;
  const StepLists<const int> L =
      StepLists<const int>::at(a.lists, T, B);
  const long long H3 = 3LL * H, BH = static_cast<long long>(B) * H,
                  BH3 = 3 * BH;
  const float** rptr = reinterpret_cast<const float**>(carry_smem_raw);
  float* ring = reinterpret_cast<float*>(carry_smem_raw + RB * 8);
  const int tid = threadIdx.x, ty = tid / UL, tx = tid % UL;
  const int u0 = blockIdx.x * BU;
  const Chain& p = blockIdx.z == 0 ? a.c[0] : a.c[1];
  const int t = p.reverse ? s : T - 1 - s;
  const bool start = p.reverse ? t == T - 1 : t == 0;  // zero h_prev
  const int tn = p.reverse ? t - 1 : t + 1;  // the step walked before
  const int n = __ldg(L.cnt + t);
  const int* rows = L.rows + static_cast<long long>(t) * B;
  // g of the step walked before (null at the walk's first step: dh is
  // dpart, the cotangent of hT), h_prev (null at the chain's zero
  // start) and step t's gh, whose row b the gh product wrote where h_prev
  // is not zero (index r B + b of the packed list).
  const float* gprev = s == 0 ? nullptr : p.gq + tn * BH3;
  const float* hprev =
      start ? nullptr : p.hseq + (p.reverse ? t + 1 : t - 1) * BH;
  const float* ght =
      start ? nullptr : p.gh + (p.reverse ? t : t - 1) * BH3;
  const float* gxt = p.gx + t * BH3;
  float* dgxt = p.dgx + t * BH3;
  float* gqt = p.gq + t * BH3;
  float bh[TU];
#pragma unroll
  for (int e = 0; e < TU; ++e) {
    const int u = u0 + tx + UL * e;
    bh[e] = u < H ? __ldg(p.bhn + u) : 0.f;
  }
  for (int p0 = 0; p0 < n; p0 += RB) {
    const int nr = min(RB, n - p0);
    // rows a thread: the fewest that cover the pass (TR for 4-byte
    // copies)
    const int trn = V16 ? (nr + RG - 1) / RG : TR;
    float acc[TR][TU];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int e = 0; e < TU; ++e) acc[i][e] = 0.f;
    if (gprev != nullptr) {
      // g's rows of the pass; a row dead at the step walked before has
      // a zero g row there: zero-filled, not read.
      for (int r = tid; r < trn * RG; r += THREADS) {
        const float* q = nullptr;
        if (r < nr) {
          const int b = __ldg(rows + p0 + r);
          if (tn < __ldg(a.lens + b)) q = gprev + b * H3;
        }
        rptr[r] = q;
      }
      __syncthreads();
      if constexpr (V16)
        carry_pass<TU>(trn, rptr, p.uh, H, u0, ring, acc);
      else
        carry_products<TR, TU, false>(rptr, p.uh, H, u0, ring, acc);
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int j = p0 + ty + RG * i;
      if (i >= trn || j >= n) continue;
      const int b = __ldg(rows + j);
      const float* gxb = gxt + b * H3;
      // The reverse chain's h_prev is zero at a row's first step (t =
      // lens - 1): its gh is 0, not written.
      const float* ghb =
          ght != nullptr && (!p.reverse || t + 1 < __ldg(a.lens + b))
              ? ght + b * H3
              : nullptr;
#pragma unroll
      for (int e = 0; e < TU; ++e) {
        const int u = u0 + tx + UL * e;
        if (u >= H) continue;
        const long long o = static_cast<long long>(b) * H + u;
        // dh = dpart + g_prev U_h^T, rounded as the persistent chain
        // adds it; the walk's first step carries dpart (the cotangent of
        // hT).
        const float d0 = p.dpart[o];
        const float d = gprev != nullptr ? __fadd_rn(d0, acc[i][e]) : d0;
        const gru_f32::Gates q = gru_f32::gates(
            __ldg(gxb + u), __ldg(gxb + H + u), __ldg(gxb + 2 * H + u),
            ghb != nullptr ? __ldg(ghb + u) : 0.f,
            ghb != nullptr ? __ldg(ghb + H + u) : 0.f,
            ghb != nullptr ? __ldg(ghb + 2 * H + u) : 0.f, bh[e]);
        const float hp = hprev != nullptr ? __ldg(hprev + o) : 0.f;
        const gru_f32::Cotangents c = gru_f32::cell_bwd(q, hp, d, true);
        float* dg = dgxt + b * H3;
        dg[u] = c.da_r;
        dg[H + u] = c.da_z;
        dg[2 * H + u] = c.da_n;
        float* gqb = gqt + b * H3;
        gqb[u] = c.da_r;
        gqb[H + u] = c.da_z;
        gqb[2 * H + u] = c.dgh_n;
        p.dpart[o] = c.dpart;
      }
    }
  }
  // The dead rows of step t: zero g and dgx in the block's columns.
  for (int i = tid; i < (B - n) * BU; i += THREADS) {
    const int uu = i % BU, u = u0 + uu;
    if (u >= H) continue;
    const int b = __ldg(rows + n + i / BU);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      dgxt[b * H3 + g * H + u] = 0.f;
      gqt[b * H3 + g * H + u] = 0.f;
    }
  }
}

// The units a thread of the carry may take (ops/kernels.py plans one).
template <class F>
cudaError_t by_units(int tu, F&& f) {
  switch (tu) {
    case 3:
      return f(std::integral_constant<int, 3>{});
    case 5:
      return f(std::integral_constant<int, 5>{});
    default:
      return cudaErrorInvalidValue;
  }
}


// The ring plans of the gh and dU_h products (ops/kernels.py::f32_ring_plan)
// and the carry's units a thread (ops/kernels.py::gru_f32_carry_plan).
struct Plans {
  int tu, wa, wb, stages, smem_gh, wa_duh, wb_duh, smem_duh;
};

// The step form's T + 4 launches for `chains` chains (1: c0; 2: c0 and c1,
// K7f's) under lens [B], lists the int32 scratch of StepLists:
// lists, gh, T carries, dU_h, db_hn, on `stream`, each added to
// *launched. Returns cudaErrorInvalidValue for a plan that the operands'
// alignment or the header does not allow.
inline cudaError_t launch_step_form(Chain c0, Chain c1, int chains,
                                    const int* lens, int* lists, int T, int B,
                                    int H, const Plans& pl,
                                    cudaStream_t stream, int* launched) {
  if (T < 1 || B < 1 || H < 1 || chains < 1 || chains > 2)
    return cudaErrorInvalidValue;
  const long long BH = static_cast<long long>(B) * H, H3 = 3LL * H,
                  BH3 = 3 * BH;
  const int M = (T - 1) * B;
  const Chain ch[2] = {c0, c1};
  const StepLists<int> L = StepLists<int>::at(lists, T, B);
  gru_seq_f32::GhChain gc[2];
  gru_seq_f32::DuhChain dc[2];
  CarryArgs ca{};
  for (int d = 0; d < chains; ++d) {
    const Chain& c = ch[d];
    // The saved states of live h_prev and g of the steps they precede,
    // indexed r B + b: forward hseq[r] against gq[r + 1], reverse
    // hseq[r + 1] against gq[r] (none at T = 1).
    const float* hp = c.hseq + (c.reverse && M > 0 ? BH : 0);
    const float* gp = c.gq + (!c.reverse && M > 0 ? BH3 : 0);
    const int* list = L.rowsteps;
    const int* count = L.m;
    if (!fp32_ring::plan_ok<float, true>(pl.wa, pl.wb, pl.stages,
                                         pl.smem_gh, hp, H * 4LL, c.uh,
                                         H3 * 4) ||
        !fp32_ring::plan_ok<float, false, true>(pl.wa_duh, pl.wb_duh,
                                                pl.stages, pl.smem_duh, hp,
                                                H * 4LL, gp, H3 * 4))
      return cudaErrorInvalidValue;
    gc[d] = {hp, c.uh, c.gh, list, count};
    dc[d] = {hp, gp, c.duh, list, count};
    ca.c[d] = c;
  }
  if (chains == 1) {
    gc[1] = gc[0];
    dc[1] = dc[0];
    ca.c[1] = ca.c[0];
  }
  ca.lens = lens;
  ca.lists = lists;
  ca.T = T;
  ca.B = B;
  ca.H = H;
  gru_f32_lists_kernel<<<T, LIST_THREADS, 0, stream>>>(lens, lists, T, B);
  ++*launched;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = gru_seq_f32::gh_launch(gc[0], gc[1], chains, M, H, pl.wa, pl.wb,
                             pl.smem_gh, stream, launched);
  if (e != cudaSuccess) return e;
  // 16-byte copies where g's and U_h's rows are 16-byte aligned.
  bool v16 = H % 4 == 0;
  for (int d = 0; d < chains; ++d)
    v16 = v16 && reinterpret_cast<uintptr_t>(ch[d].uh) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(ch[d].gq) % 16 == 0;
  e = by_units(pl.tu, [&](auto tuc) {
    constexpr int TU = decltype(tuc)::value;
    void (*kernel)(CarryArgs) = v16 ? gru_f32_carry_kernel<TU, true>
                                    : gru_f32_carry_kernel<TU, false>;
    const int smem = carry_smem();
    cudaError_t err = fp32_ring::opt_in(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((H + UL * TU - 1) / (UL * TU), 1, chains);
    for (int s = 0; s < T; ++s) {
      ca.s = s;
      kernel<<<grid, THREADS, smem, stream>>>(ca);
      ++*launched;
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
  });
  if (e != cudaSuccess) return e;
  e = gru_seq_f32::duh_launch(dc[0], dc[1], chains, M, H, pl.wa_duh,
                              pl.wb_duh, pl.smem_duh, stream, launched);
  if (e != cudaSuccess) return e;
  return gru_f32::dbhn_launch(c0.gq, c0.dbhn, c1.gq, c1.dbhn, chains, T * B,
                              H, stream, launched);
}

}  // namespace gru_bptt_f32
