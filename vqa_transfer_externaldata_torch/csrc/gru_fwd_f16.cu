// K1h `gru_fwd` in float16: K1 (csrc/gru_fwd.cu) built with U_h and the
// exchanged copy of the state in float16, for a model.dtype float16 model.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel with a
// float16 U_h: the Pallas body rounds the state to U_h's dtype ahead of its
// f32-accumulated product (_gru_cell's h.astype(uh.dtype)), which is what
// K1's body does with its element type float16 (elem16.cuh). Launch plan,
// shared memory and speed are K1's: f16 mma.sync m16n8k16 takes the same
// fragments and ldmatrix loads at the same rate as bf16.

#define KERNEL_ELEM_F16
#include "gru_fwd.cu"
