// Device math shared by the vocoder kernels (antialias_snake.cu,
// amp_layer.cu): the kaiser-sinc taps, sin^2 by polynomial, the Snake, and
// the 2x up/down FIR taps of the anti-aliased activation.
//
// Counterpart of promptttspp_tpu/ops/pallas/polyops.py::sin2 and of the tap
// formulas in promptttspp_tpu/ops/pallas/snake.py (module docstring):
//   up:    u[2q]   = 2 * sum_i f[2i]   * x[clamp(q + i - 3)]   (i = 0..5)
//          u[2q+1] = 2 * sum_i f[2i+1] * x[clamp(q + i - 2)]
//   snake: s[m] = u[m] + sin^2(a * u[m]) / (a + 1e-9),  a = exp(alpha)
//   down:  y[t] = sum_n f[n] * s[clamp(2t - 5 + n, 0, 2T - 1)]  (n = 0..11)
// where clamp() is edge replication at the signal's ends.
#pragma once

#include <cuda_runtime.h>

namespace ptts {

// kaiser_sinc_filter1d(0.25, 0.3, 12) in float32, exactly
// (promptttspp_tpu_torch/vocoders/activations.py; a CPU test reads these
// literals back and compares them).
__constant__ float kFir[12] = {
    0x1.09f0d2p-9f,  0x1.33ac88p-7f, -0x1.a2810ep-6f, -0x1.d85448p-5f,
    0x1.075114p-3f,  0x1.c5d8cap-2f,  0x1.c5d8cap-2f,  0x1.075114p-3f,
    -0x1.d85448p-5f, -0x1.a2810ep-6f, 0x1.33ac88p-7f,  0x1.09f0d2p-9f,
};

// sin(z)^2: reduce t = z/pi - rint(z/pi) to [-1/2, 1/2], then a degree-7
// polynomial in t^2 (max abs error 2.0e-10), 7 fma.
__device__ __forceinline__ float sin2(float z) {
  float t = z * 0.318309886183790671538f;
  t = t - rintf(t);
  const float u = t * t;
  float p = 0.7304793718262736f;
  p = fmaf(p, u, -3.903308433149872f);
  p = fmaf(p, u, 13.203381813096923f);
  p = fmaf(p, u, -30.121232542884073f);
  p = fmaf(p, u, 42.72834270494695f);
  p = fmaf(p, u, -32.46969505718645f);
  p = fmaf(p, u, 9.869604379110031f);
  p = fmaf(p, u, 4.0317083005447785e-11f);
  return p;
}

__device__ __forceinline__ float snake(float u, float a, float inv_a) {
  return u + inv_a * sin2(u * a);
}

// Upsampled value u[m] from staged, edge-clamped x rows. `xs` holds
// x[clamp(x0 + l)] at row l (row stride `ld`); m is already clamped to
// [0, 2T - 1].
__device__ __forceinline__ float up2_at(const float* xs, int ld, int x0,
                                        int m) {
  const int q = m >> 1;
  float acc = 0.f;
  if ((m & 1) == 0) {
    const float* r = xs + (q - 3 - x0) * ld;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc = fmaf(kFir[2 * i], r[i * ld], acc);
  } else {
    const float* r = xs + (q - 2 - x0) * ld;
#pragma unroll
    for (int i = 0; i < 6; ++i) acc = fmaf(kFir[2 * i + 1], r[i * ld], acc);
  }
  return 2.f * acc;
}

// Downsampled value from 12 consecutive staged s rows starting at `s`.
__device__ __forceinline__ float down2_at(const float* s, int ld) {
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < 12; ++n) acc = fmaf(kFir[n], s[n * ld], acc);
  return acc;
}

}  // namespace ptts
