// The uniform quantizer's level index and decode, shared by
// quant_pipeline.cu and quantize_ef.cu so both round alike.
//
//   idx     = clip(floor(fma(clip(x, vmin, vmax) - vmin, 1/delta, 0.5)), 0, L)
//   decoded = fma(idx, delta, vmin)
//
// Bit-exact with the plain version and with the Pallas kernels as XLA
// compiles them: XLA turns the division by the constant delta into a
// product with its float32 reciprocal and contracts each multiply and add
// into a fused multiply-add.  delta is the float32 rounding of
// (vmax - vmin) / L and recip = 1.0f / delta in float32, both passed by
// the caller.  Each step is an explicitly rounded intrinsic (__fsub_rn,
// __fmaf_rn), so nvcc can contract nothing else.  No fast-math.
#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float level_index(float x, float levels, float vmin,
                                            float vmax, float recip) {
  const float clipped = fminf(fmaxf(x, vmin), vmax);
  const float level = floorf(__fmaf_rn(__fsub_rn(clipped, vmin), recip, 0.5f));
  return fminf(fmaxf(level, 0.0f), levels);
}

__device__ __forceinline__ float decode_level(float level, float delta,
                                             float vmin) {
  return __fmaf_rn(level, delta, vmin);
}

}  // namespace repro
