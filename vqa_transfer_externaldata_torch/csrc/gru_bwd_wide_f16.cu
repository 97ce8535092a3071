// K3h and K7h in the step form: csrc/gru_bwd_wide.cu built with U_h, the
// copy of the pre-step states and the staged gate cotangents in float16,
// for a model.dtype float16 model at the widths the persistent step kernel
// cannot take.
//
// Replaces vqa_transfer_externaldata_tpu/ops/gru.py::_gru_bwd_kernel and
// ::_bigru_bwd_kernel with a float16 U_h there: h_prev and the gate
// cotangents rounded to float16 ahead of their products, as the Pallas
// bodies round them to U_h's dtype. Launches, bound and design are the bf16
// build's.

#define KERNEL_ELEM_F16
#include "gru_bwd_wide.cu"
