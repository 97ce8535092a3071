// K8h `attention_bwd` in float16: K8 (csrc/attention_bwd.cu) built with
// float16 as its element type (elem16.cuh), for a model.dtype float16
// model: a float16 grid and W_v, dz * r staged in float16, f32 sums.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention.py::_make_bwd_kernel
// with a float16 grid: the Pallas body rounds dz * r to dt (dz_r.astype(dt))
// ahead of the dW_v product, which is what K8's dz epilogue does with its
// element type float16 (to nearest; a product below f16's smallest normal
// keeps its subnormal bits, one below the smallest subnormal is 0 in
// both). Launches, tiles and shared memory are K8's.

#define KERNEL_ELEM_F16
#include "attention_bwd.cu"
