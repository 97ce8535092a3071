// K6 `bigru_fwd`: both recurrences of a bidirectional GRU, advanced
// together, for Hopper (sm_90a). The same source builds K6h
// (csrc/bigru_fwd_f16.cu), the float16 instance: E = KernelElem
// (elem16.cuh), U_h's type and the exchanged state's, is bf16 here and
// float16 there.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_fwd_kernel (the
// Pallas body launched by _bigru_pallas_fwd_call): grid step k advances the
// forward chain at t = k and the backward chain at t = T-1-k, both under the
// prefix mask t < lens[b], so the backward chain walks each row's padded
// tail first and carries the zero state through it (as K1 with `reverse`).
// The cell math is _gru_cell, gru_cell in gru_fwd_step.cuh.
//
// What bounds it on an H100: at B=256, T=26, H=512 the two chains do about
// 2 x 2 x sum(lens) x H x 3H operations (~11 GFLOP, 11 us at the bf16
// and f16 peak) and must move the live rows of gx in and hseq out for both
// (~2 x 35 MB, ~21 us at 3.35 TB/s): the bytes bound it. The real limit is, as
// for K1, the latency of 26 dependent steps, each too small to fill the
// card alone.
//
// Design: K1's persistent kernel (gru_seq_kernel of gru_fwd_step.cuh) with
// the direction on blockIdx.z. One cooperative launch walks all T steps of
// both chains, one grid barrier a step for both: at B=256, H=512 that is 32
// j-tiles x 2 rows x 2 directions, 128 blocks of 64 rows, one an SM, each
// holding its direction's U_h columns in shared memory and walking 2 of the
// 4 b-tiles a step (ops/kernels.py::gru_fwd_plan fits both directions'
// j-tiles on the card). Each direction exchanges its own E ping-pong copy
// of the state. Where both directions' j-tiles cannot be resident at
// once but one direction's can (H above 1056 on an H100), the same kernel
// is launched once a chain on the same stream. Each direction's outputs
// equal a K1 call with the same `reverse` bit, bit for bit.

#include "gru_fwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// As gru_fwd_config (csrc/gru_fwd.cu), for this library's instance of the
// persistent kernel and both directions: grid[3] is (j-tiles, rows of
// blocks, 2), or (j-tiles, rows of blocks, 1) with 2 launches where only
// one direction's j-tiles are resident at once.
int bigru_fwd_config(int B, int H, int rows, int* grid, int* launches,
                     int* per_sm, long long* smem_bytes) {
  return seq_config<KernelElem>(B, H, rows, 2, grid, launches, per_sm,
                                smem_bytes);
}

// gxf, gxb [T, B, 3H] f32, lens [B] i32, uhf, uhb [H, 3H] E, bhnf, bhnb
// [H] f32 -> hseq [2, T, B, H] f32 (forward chain, then backward chain; the
// post-step state of actual timestep t), hT [2, B, H]; scratch hbf
// [2, 2, B, H] E (each direction's ping-pong copy). `rows` (16 or 64)
// batch rows a block, as ops/kernels.py::gru_fwd_plan chooses them with two
// directions. Needs H % 16 == 0 (checked by the caller). Launches the
// persistent kernel cooperatively on `stream`, once for both chains (or
// once a chain, seq_run), counting in *launched those that launched;
// returns the first CUDA error.
int bigru_fwd(const void* gxf, const void* gxb, const void* lens,
              const void* uhf, const void* uhb, const void* bhnf,
              const void* bhnb, void* hseq, void* hT, void* hbf, int T,
              int B, int H, int rows, void* stream, int* launched) {
  const size_t step_h = static_cast<size_t>(B) * H;
  const int* ln = static_cast<const int*>(lens);
  float* const hs = static_cast<float*>(hseq);
  float* const ht = static_cast<float*>(hT);
  using E = KernelElem;
  E* const hb = static_cast<E*>(hbf);
  const FwdSeq<E> f{static_cast<const float*>(gxf), ln,
                    static_cast<const E*>(uhf),
                    static_cast<const float*>(bhnf), hs, ht, hb,
                    T, B, H, rows, 0};
  const FwdSeq<E> b{static_cast<const float*>(gxb), ln,
                    static_cast<const E*>(uhb),
                    static_cast<const float*>(bhnb), hs + T * step_h,
                    ht + step_h, hb + 2 * step_h, T, B, H, rows, 1};
  return seq_run<E>({f, b}, 2, rows, static_cast<cudaStream_t>(stream),
                    launched);
}

}  // extern "C"
