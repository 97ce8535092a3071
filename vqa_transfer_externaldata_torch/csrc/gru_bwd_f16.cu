// K3h `gru_bwd` in float16: K3 (csrc/gru_bwd.cu) built with U_h, the copy
// of the pre-step states and the staged gate cotangents in float16, for a
// model.dtype float16 model.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel with a
// float16 U_h: the Pallas body rounds h_prev and the gate cotangents to
// U_h's dtype ahead of the U_h^T product and of dU_h
// (da_*.astype(uht_ref.dtype)), which is what K3's body does with its
// element type float16 (elem16.cuh); a cotangent below f16's smallest
// subnormal is 0 in both. Launches, grid and shared memory are K3's.

#define KERNEL_ELEM_F16
#include "gru_bwd.cu"
