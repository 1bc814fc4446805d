// Device math shared by the vocoder kernels (antialias_snake.cu,
// amp_layer_tc.cu, amp_block.cu): the kaiser-sinc taps, sin^2 by
// polynomial, the Snake, the 2x up/down FIR taps of the anti-aliased
// activation, and AA over a run of samples from registers (aa_run).
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

// The 2x-rate Snake value at m (in [0, 2T)) of one channel, read from
// device memory: xc points at the channel's sample 0, samples C apart;
// indices clamp to [0, T).
__device__ __forceinline__ float snake_at(const float* __restrict__ xc, int C,
                                          int T, int m, float a,
                                          float inv_a) {
  const int q = m >> 1;
  const int o = (m & 1) ? -2 : -3;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc = fmaf(kFir[2 * i + (m & 1)],
               xc[(size_t)min(max(q + o + i, 0), T - 1) * C], acc);
  return snake(2.f * acc, a, inv_a);
}

// The 2x-rate Snake values and down-FIR sums of aa_run, with (EDGE) or
// without the substitution of the end values s_lo, s_hi for m outside
// [0, 2T).
template <int R, bool EDGE, class Emit>
__device__ __forceinline__ void aa_run_sums(const float (&xw)[R + 10],
                                            float a, float inv_a, int m0,
                                            int T, float s_lo, float s_hi,
                                            Emit& emit) {
  float out[R];
#pragma unroll
  for (int r = 0; r < R; ++r) out[r] = 0.f;
#pragma unroll
  for (int jj = 0; jj < 2 * R + 10; ++jj) {
    // m = m0 + jj is odd for even jj: taps kFir[2i + 1] from x[q - 2]
    float u = 0.f;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      u = fmaf(kFir[2 * i + (jj % 2 == 0 ? 1 : 0)], xw[jj / 2 + i], u);
    float s = snake(2.f * u, a, inv_a);
    if constexpr (EDGE) {
      const int m = m0 + jj;
      s = m < 0 ? s_lo : (m > 2 * T - 1 ? s_hi : s);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = jj - 2 * r;
      if (n >= 0 && n < 12) out[r] = fmaf(kFir[n], s, out[r]);
    }
    if (jj >= 11 && jj % 2 == 1) emit((jj - 11) / 2, out[(jj - 11) / 2]);
  }
}

// AA from registers: emit(r, y) with y = down2(snake(up2(x)))[p0 + r] for
// r < R, one channel (xc, C, T as in snake_at; a = exp(alpha),
// inv_a = 1 / (a + 1e-9)). The run reads the R + 10 inputs x[p0 - 5 ..]
// (clamped), forms the 2R + 10 2x-rate Snake values m = 2 p0 - 5 + jj one
// at a time and adds each into the up to six outputs it feeds: output r
// sums kFir[n] * s[2r + n], n = 0..11, in down2_at's order, and is emitted
// as soon as its last term is in; an m outside [0, 2T) takes the value at
// the nearest end (only runs within 5 samples of an end test for that).
// Outputs at p0 + r outside [0, T) follow the same formulas; callers mask
// them.
template <int R, class Emit>
__device__ __forceinline__ void aa_run(const float* __restrict__ xc, int C,
                                       int T, int p0, float a, float inv_a,
                                       Emit&& emit) {
  float xw[R + 10];
#pragma unroll
  for (int i = 0; i < R + 10; ++i)
    xw[i] = xc[(size_t)min(max(p0 - 5 + i, 0), T - 1) * C];
  const int m0 = 2 * p0 - 5;
  if (m0 < 0 || m0 + 2 * R + 9 > 2 * T - 1)
    aa_run_sums<R, true>(xw, a, inv_a, m0, T,
                         snake_at(xc, C, T, 0, a, inv_a),
                         snake_at(xc, C, T, 2 * T - 1, a, inv_a), emit);
  else
    aa_run_sums<R, false>(xw, a, inv_a, m0, T, 0.f, 0.f, emit);
}

}  // namespace ptts
