// K6h `bigru_fwd` in float16: K6 (csrc/bigru_fwd.cu) built with U_h and
// each direction's exchanged copy of the state in float16, for a
// model.dtype float16 model.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_bigru_fwd_kernel with
// float16 U_h: the Pallas body's cell (_gru_cell) rounds each chain's
// state to U_h's dtype ahead of its f32-accumulated product
// (h.astype(uh_ref.dtype)), which is what K6's body does with its element
// type float16. Launch plan, shared memory and speed are K6's, and each
// direction equals a K1h call (csrc/gru_fwd_f16.cu) bit for bit.

#define KERNEL_ELEM_F16
#include "bigru_fwd.cu"
