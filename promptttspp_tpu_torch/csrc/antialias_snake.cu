// Kernel K1: anti-aliased Snake, y = down2(snake(up2(x))), over [B, T, C]
// float32 (channel-last, contiguous), for any C.
//
// Replaces promptttspp_tpu/ops/pallas/snake.py::fused_antialias_snake.
// Memory-bound on an H100 (one read of x, one write of y, ~90 flops per
// output): each block stages its x tile plus a 6-sample halo in shared
// memory, computes the 2x-rate snake values there, and writes only y, so
// the 2x-rate intermediate never reaches device memory.
//
// Block: 32 channels (one warp across channels, coalesced 128-byte rows) x
// 8 rows of threads; tile: TT output samples. Output t reads
// x[t-6 .. t+5] (clamped) through s[2t-5 .. 2t+6] (clamped to [0, 2T-1]).
#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

constexpr int TT = 96;           // output samples per block
constexpr int CW = 32;           // channels per block
constexpr int ROWS = 8;          // thread rows
constexpr int NX = TT + 12;      // staged x rows: t0-6 .. t0+TT+5
constexpr int NS = 2 * TT + 10;  // staged s rows: m = 2t0-5 .. 2t0+2TT+4

__global__ void __launch_bounds__(CW * ROWS)
antialias_snake_kernel(const float* __restrict__ x,
                       const float* __restrict__ alpha,
                       float* __restrict__ y, int T, int C) {
  __shared__ float xs[NX * CW];
  __shared__ float ss[NS * CW];
  const int cc = threadIdx.x;
  const int c = blockIdx.y * CW + cc;
  const bool cv = c < C;
  const int t0 = blockIdx.x * TT;
  const size_t batch = (size_t)blockIdx.z * T * C;
  const float a = cv ? expf(alpha[c]) : 1.f;
  const float inv_a = 1.f / (a + 1e-9f);

  const int x0 = t0 - 6;
  for (int l = threadIdx.y; l < NX; l += ROWS) {
    const int p = min(max(x0 + l, 0), T - 1);
    xs[l * CW + cc] = cv ? x[batch + (size_t)p * C + c] : 0.f;
  }
  __syncthreads();

  const int m0 = 2 * t0 - 5;
  for (int j = threadIdx.y; j < NS; j += ROWS) {
    const int m = min(max(m0 + j, 0), 2 * T - 1);
    ss[j * CW + cc] = ptts::snake(ptts::up2_at(xs + cc, CW, x0, m), a, inv_a);
  }
  __syncthreads();

  if (!cv) return;
  for (int r = threadIdx.y; r < TT; r += ROWS) {
    const int t = t0 + r;
    if (t >= T) break;
    // s rows for 2t-5+n start at local row 2t-5 - m0 = 2r
    y[batch + (size_t)t * C + c] = ptts::down2_at(ss + 2 * r * CW + cc, CW);
  }
}

}  // namespace

extern "C" int antialias_snake(const float* x, const float* alpha, float* y,
                               int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TT - 1) / TT, (C + CW - 1) / CW, B);
  const dim3 block(CW, ROWS);
  antialias_snake_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, alpha, y, T, C);
  return (int)cudaGetLastError();
}
