// The block-wide argmax of the CUDA kernels: (value, index) pairs where
// the larger value wins and ties go to the lower node index (the
// reference's first-max tie-break).  Device code only.
#pragma once

namespace vt {

__device__ __forceinline__ void take_better(float& bv, int& bi, float ov, int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    take_better(bv, bi, ov, oi);
  }
}

}  // namespace vt
