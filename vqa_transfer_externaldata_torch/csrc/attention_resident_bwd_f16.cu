// K5h `attention_resident_bwd` in float16: K5 (csrc/attention_resident_bwd.cu)
// built with float16 as its element type (elem16.cuh), for a model.dtype
// float16 model: the saved h, the staged cotangent rows g and dz * r in
// float16, float16 store rows (or int8 codes widened to float16), f32 sums.
//
// Replaces vqa_transfer_externaldata_tpu/ops/attention_resident.py::
// _make_bwd_kernel_multi with a float16 store: the Pallas body rounds g and
// dz * r to dt (its astype(dt) at the g rows and dz_r), which is what K5's
// body does with its element type float16; a cotangent below f16's
// smallest subnormal is 0 in both. Launches, tiles and shared memory are
// K5's.

#define KERNEL_ELEM_F16
#include "attention_resident_bwd.cu"
