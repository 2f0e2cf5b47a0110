// Shared by the forward and backward flash AAM kernels (sm_90a): the ArcFace
// margin.  Their common cosine tile is in flash_aam_cosine.cuh.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace flash_aam {

constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Margin {
  float s, cos_m, sin_m, th, mm;
};

// The margined, scaled logit.  The _rn intrinsics keep nvcc from contracting
// these steps into FMAs, so each rounds as the plain PyTorch version does.
__device__ __forceinline__ float margined(float cos, bool is_tgt, const Margin& mg) {
  float z = cos;
  if (is_tgt) {
    float sin2 = __fsub_rn(1.0f, __fmul_rn(cos, cos));
    float sin = sqrtf(fminf(fmaxf(sin2, 1e-12f), 1.0f));
    float phi = __fsub_rn(__fmul_rn(cos, mg.cos_m), __fmul_rn(sin, mg.sin_m));
    z = (__fsub_rn(cos, mg.th) > 0.0f) ? phi : __fsub_rn(cos, mg.mm);
  }
  return __fmul_rn(z, mg.s);
}

}  // namespace flash_aam
