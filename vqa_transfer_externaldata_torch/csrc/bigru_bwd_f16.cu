// K7h `bigru_bwd` in float16: K7 (csrc/bigru_bwd.cu) built with U_h, the
// copy of the pre-step states and the staged gate cotangents in float16,
// for a model.dtype float16 model.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_bwd_kernel with
// float16 U_h: the Pallas body's step (_gru_cell_bwd) rounds h_prev and
// each gate cotangent to U_h's dtype ahead of the U_h^T product and dU_h,
// which is what K7's body does with its element type float16. Launches and
// shared memory are K7's, and each direction equals a K3h call
// (csrc/gru_bwd_f16.cu) bit for bit.

#define KERNEL_ELEM_F16
#include "bigru_bwd.cu"
