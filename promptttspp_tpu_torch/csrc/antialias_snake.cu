// Kernel K1: anti-aliased Snake, y = down2(snake(up2(x))), over [B, T, C]
// float32 (channel-last, contiguous), for any C.
//
// Replaces promptttspp_tpu/ops/pallas/snake.py::fused_antialias_snake (both
// of its Pallas bodies). Bound by bytes on an H100: one read of x and one
// write of y against ~90 flops per output, so at act_post, [1, 153600, 32],
// the bound is 39.3 MB at 3.35 TB/s, 0.0117 ms; the Snake's ~25 float32
// instructions per 2x-rate value come to about as much issue time.
//
// Design: no shared memory and no barrier. Each thread computes a run of R
// consecutive outputs of one channel from registers with ptts::aa_run, the
// AA routine that K2 (amp_layer_tc.cu) uses: it loads the R + 10 inputs the
// run reads, forms the 2R + 10 2x-rate Snake values one at a time, adds
// each into the outputs it feeds and stores each output once it is
// complete, so the 2x-rate intermediate never leaves registers. Thread i
// of a batch row (blockIdx.y) takes channel i % C of run i / C: a warp
// spans consecutive channels, so at C >= 32 each of its loads and stores
// is one coalesced 128-byte row, and neighbouring runs' 10 shared input
// rows come from L1. Any C works (a warp then spans the end of one run and
// the start of the next), and so does a T shorter than one run.
#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int R = 16;  // outputs per thread run

__global__ void __launch_bounds__(THREADS)
antialias_snake_kernel(const float* __restrict__ x,
                       const float* __restrict__ alpha,
                       float* __restrict__ y, int T, int C, int items) {
  const int item = blockIdx.x * THREADS + threadIdx.x;  // of this batch row
  if (item >= items) return;
  const int c = item % C;
  const int p0 = item / C * R;
  const size_t off = (size_t)blockIdx.y * T * C + c;
  const float a = expf(alpha[c]);
  const float inv_a = 1.f / (a + 1e-9f);
  float* yc = y + off;
  ptts::aa_run<R>(x + off, C, T, p0, a, inv_a, [&](int r, float v) {
    if (p0 + r < T) yc[(size_t)(p0 + r) * C] = v;
  });
}

}  // namespace

extern "C" int antialias_snake(const float* x, const float* alpha, float* y,
                               int B, int T, int C, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const long long items = (long long)(T + R - 1) / R * C;  // per batch row
  if (items > 0x7fffffffLL - THREADS || B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((items + THREADS - 1) / THREADS), B);
  antialias_snake_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, alpha, y, T, C, (int)items);
  return (int)cudaGetLastError();
}
