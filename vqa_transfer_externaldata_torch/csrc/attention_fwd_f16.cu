// K2h `attention_fwd` in float16: K2 (csrc/attention_fwd.cu) built with
// float16 as its element type (elem16.cuh), for a model.dtype float16
// model: a float16 grid and W_v, f16 wgmma products summed in f32.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_kernel
// with a float16 grid: the Pallas body squares v in dt (jnp.square(v)) and
// rounds its weights p * r to dt (pw.astype(dt)) ahead of the weighted
// sum, which is what K2's body does with its element type float16. A cell
// holding a value past 256 squares to inf in float16, so its r is 0 in
// both. Launches, tiles and shared memory are K2's.

#define KERNEL_ELEM_F16
#include "attention_fwd.cu"
