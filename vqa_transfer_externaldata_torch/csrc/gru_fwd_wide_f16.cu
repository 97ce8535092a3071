// K1h and K6h in the step form: csrc/gru_fwd_wide.cu built with U_h and the
// exchanged copy of the state in float16, for a model.dtype float16 model
// at the widths the persistent kernel cannot take.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_fwd_kernel and
// ::_bigru_fwd_kernel with a float16 U_h there: the Pallas bodies round the
// state to U_h's dtype ahead of its f32-accumulated product, which is what
// the step form's body does with its element type float16 (elem16.cuh).
// Launches, bound and design are the bf16 build's.

#define KERNEL_ELEM_F16
#include "gru_fwd_wide.cu"
