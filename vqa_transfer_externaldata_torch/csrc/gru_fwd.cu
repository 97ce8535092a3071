// K1 `gru_fwd`: the fused GRU forward recurrence, for Hopper (sm_90a). The
// same source builds K1h (csrc/gru_fwd_f16.cu), the float16 instance: E =
// KernelElem (elem16.cuh) is bf16 here and float16 there, U_h's type and
// the exchanged state's.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel (the
// Pallas body launched by _gru_pallas_fwd_call); the step math is that
// file's _gru_cell, written out as gru_cell in gru_fwd_step.cuh.
//
// What bounds it on an H100: at B=256, T=26, H=512 the recurrence must read
// the live rows of gx (~3500 row-steps of 6 KB) and write hseq (14 MB),
// about 11 us at 3.35 TB/s; its 2 x 3500 x 512 x 1536 operations take 6 us
// at the bf16 peak. The real limit is latency: 26 dependent steps, each a
// [B, H] x [H, 3H] product for which every block needs all of h_prev.
//
// Design: the persistent kernel of gru_fwd_step.cuh (gru_seq_kernel), one
// cooperative launch for all T steps with one direction (gridDim.z = 1);
// each block's U_h columns stay resident in shared memory, the state is
// exchanged as an E ping-pong copy [2, B, H]. K6 (csrc/bigru_fwd.cu)
// launches the same kernel with two directions: each of its chains equals a
// K1 call bit for bit.

#include "gru_fwd_step.cuh"

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch at batch B and width H with b-tiles of `rows` (16 or 64) rows
// on the current device: its grid[3] (j-tiles, rows of blocks, 1; 0 x 0 x 0
// where a row of H / 16 j-tiles cannot be resident at once), the launches
// it takes (1, or 0 with a zero grid), the blocks resident per SM (0 where
// the shared memory exceeds a block's) and the dynamic shared memory.
// Returns the CUDA error of the queries, clearing it from the runtime so
// that later launch checks of other kernels do not report it again.
int gru_fwd_config(int B, int H, int rows, int* grid, int* launches,
                   int* per_sm, long long* smem_bytes) {
  return seq_config<KernelElem>(B, H, rows, 1, grid, launches, per_sm,
                                smem_bytes);
}

// gx_t [T, B, 3H] f32, lens [B] i32, uh [H, 3H] E, bhn [H] f32
// -> hseq [T, B, H] f32 (post-step state of actual timestep t), hT [B, H];
// scratch hbf [2, B, H] E. `rows` (16 or 64) batch rows a block, as
// ops/kernels.py::gru_fwd_plan chooses them; the grid is derived from them
// (seq_grid). Needs H % 16 == 0 (checked by the caller). Launches the
// persistent kernel cooperatively on `stream` (1), counting in *launched
// whether it launched; returns the CUDA error, among them
// cudaErrorCooperativeLaunchTooLarge when the grid cannot be resident.
int gru_fwd(const void* gx_t, const void* lens, const void* uh,
            const void* bhn, void* hseq, void* hT, void* hbf, int T, int B,
            int H, int reverse, int rows, void* stream, int* launched) {
  using E = KernelElem;
  const FwdSeq<E> p{static_cast<const float*>(gx_t),
                    static_cast<const int*>(lens),
                    static_cast<const E*>(uh),
                    static_cast<const float*>(bhn),
                    static_cast<float*>(hseq),
                    static_cast<float*>(hT),
                    static_cast<E*>(hbf),
                    T, B, H, rows, reverse};
  return seq_run<E>({p, p}, 1, rows, static_cast<cudaStream_t>(stream),
                    launched);
}

}  // extern "C"
