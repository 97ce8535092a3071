// K4h `attention_resident_fwd` in float16: K4 (csrc/attention_resident_fwd.cu)
// built with float16 as its element type (elem16.cuh), for a model.dtype
// float16 model: float16 store rows (or int8 codes widened to float16),
// W_v, the squares of the per-cell norm, each glimpse's weights alpha * r
// and the saved h in float16, f32 sums.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_fwd_kernel_multi with a float16 store (dt = store.dtype, or qh's
// for int8 codes): the Pallas body's products, roundings and int8 branch
// are K4's with float16 in place of bf16. Launches, tiles and shared
// memory are K4's: wgmma ... .f32.f16.f16 takes the same descriptors,
// swizzle and fragments at the same rate as bf16.

#define KERNEL_ELEM_F16
#include "attention_resident_fwd.cu"
