// Kernel K2: one BigVGAN AMPLayer, y = x + conv2(AA2(conv1(AA1(x)))),
// float32, [B, T, C] channel-last, as two launches of one kernel:
//
//   aa_conv(x, alpha1, w1, b1, d, residual = none) -> h = conv1(AA1(x))
//   aa_conv(h, alpha2, w2, b2, 1, residual = x)    -> y = x + conv2(AA2(h))
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer. Edge rules
// (amp.py:231-255, 296-310) hold by construction: AA reads its input with
// indices clamped to [0, T) (edge replication, which for the second launch
// is "conv1's output replicated before AA2"), and the conv reads zeros
// outside [0, T).
//
// Bound: the channel mix (2*k*C^2 flops per sample and conv) outweighs the
// bytes, so it is bound by operations; this version runs it on the CUDA
// cores in float32 (no tensor cores), which meets both conv_precision
// tolerances of the JAX kernel. Design: a block owns TT output samples x
// COT output channels. Phase 1 builds A = AA(x) over TT + 2*hc samples and
// all C input channels in shared memory, 32 channels at a time through
// staged x and 2x-rate s tiles. Phase 2 gives each thread a 4 x 4
// register tile of outputs and accumulates over (tap, input channel) with
// the 4 weights as one float4 load (weights stay L2-resident, at most
// 2.9 MB per conv) and 4 broadcast A reads from shared memory. The weights
// are prepared once per tensor and may have left L2 since their last use,
// so every block first prefetches its share of them into L2; the dependent
// weight loads of phase 2 then hit L2 even in the first wave of blocks.
#include <cstdint>

#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RT = 4;        // output samples per thread
constexpr int RC = 4;        // output channels per thread (one float4)
constexpr int MAX_COT = 64;  // output channels per block
constexpr int MAX_CW = 32;   // input channels per AA staging chunk

struct Tile {
  int cot;  // output channels per block
  int ncg;  // channel groups of RC per block
  int ntg;  // time groups of RT per block
  int tt;   // output samples per block
  int hc;   // conv halo: (k - 1) / 2 * d
  int na;   // A rows: tt + 2 * hc
  int cw;   // AA staging chunk width
  int lda;  // A row stride (C + 1: rows 4 apart fall in different banks)
};

__host__ __device__ inline Tile make_tile(int C, int k, int d) {
  Tile g;
  g.cot = C < MAX_COT ? C : MAX_COT;
  g.ncg = g.cot / RC;
  g.ntg = THREADS / g.ncg;
  g.tt = g.ntg * RT;
  g.hc = (k - 1) / 2 * d;
  g.na = g.tt + 2 * g.hc;
  g.cw = C < MAX_CW ? C : MAX_CW;
  g.lda = C + 1;
  return g;
}

inline size_t smem_bytes(const Tile& g) {
  return sizeof(float) * ((size_t)g.na * g.lda + (size_t)(g.na + 12) * g.cw +
                          (size_t)(2 * g.na + 10) * g.cw);
}

__global__ void __launch_bounds__(THREADS)
aa_conv_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ residual, float* __restrict__ y,
               int T, int C, int k, int d) {
  extern __shared__ float smem[];
  const Tile g = make_tile(C, k, d);
  float* A = smem;                            // [na][lda]
  float* X = A + (size_t)g.na * g.lda;        // [na + 12][cw]
  float* S = X + (size_t)(g.na + 12) * g.cw;  // [2 * na + 10][cw]
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * g.tt;
  const int co0 = blockIdx.y * g.cot;
  const size_t batch = (size_t)blockIdx.z * T * C;

  {  // this block's share of the weights' 128-byte lines into L2
    const size_t lines = ((size_t)k * C * C * sizeof(float) + 127) / 128;
    const size_t blocks = (size_t)gridDim.x * gridDim.y * gridDim.z;
    const size_t b =
        blockIdx.x + gridDim.x * (blockIdx.y + (size_t)gridDim.y * blockIdx.z);
    const char* wb = reinterpret_cast<const char*>(w);
    for (size_t i = b * THREADS + tid; i < lines; i += blocks * THREADS)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(wb + i * 128));
  }

  // Phase 1: A[l][c] = AA(x)[a0 + l][c] for a0 + l in [0, T), else 0.
  const int a0 = t0 - g.hc;   // sample of A row 0
  const int x0 = a0 - 6;      // sample of X row 0
  const int m0 = 2 * a0 - 5;  // 2x-rate index of S row 0
  const int cc = tid % g.cw;
  const int ry = tid / g.cw;
  const int rstride = THREADS / g.cw;
  const bool row_thread = ry < rstride;
  for (int c0 = 0; c0 < C; c0 += g.cw) {
    const int c = c0 + cc;
    const bool cv = row_thread && c < C;
    if (cv) {
      for (int l = ry; l < g.na + 12; l += rstride) {
        const int p = min(max(x0 + l, 0), T - 1);
        X[l * g.cw + cc] = x[batch + (size_t)p * C + c];
      }
    }
    __syncthreads();
    if (cv) {
      const float a = expf(alpha[c]);
      const float inv_a = 1.f / (a + 1e-9f);
      for (int j = ry; j < 2 * g.na + 10; j += rstride) {
        const int m = min(max(m0 + j, 0), 2 * T - 1);
        S[j * g.cw + cc] =
            ptts::snake(ptts::up2_at(X + cc, g.cw, x0, m), a, inv_a);
      }
    }
    __syncthreads();
    if (cv) {
      for (int l = ry; l < g.na; l += rstride) {
        const int p = a0 + l;
        // s rows for 2p-5+n start at local row 2p-5 - m0 = 2l
        A[l * g.lda + c] = (p >= 0 && p < T)
                               ? ptts::down2_at(S + 2 * l * g.cw + cc, g.cw)
                               : 0.f;
      }
    }
    // the next chunk's first __syncthreads orders these S reads before S
    // is rewritten; X is not read here
  }
  __syncthreads();

  // Phase 2: out[t0 + r][co] = b[co] + sum_j sum_ci w[j][ci][co] *
  //          A[r + j*d][ci] (+ residual), r in this thread's 4 rows.
  const int cg = tid % g.ncg;
  const int tg = tid / g.ncg;
  const int co = co0 + cg * RC;
  if (tg >= g.ntg || co >= C) return;
  const int r0 = tg * RT;
  const float4 bv = *reinterpret_cast<const float4*>(bias + co);
  float acc[RT][RC];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    acc[q][0] = bv.x;
    acc[q][1] = bv.y;
    acc[q][2] = bv.z;
    acc[q][3] = bv.w;
  }
  for (int j = 0; j < k; ++j) {
    const float* wj = w + (size_t)j * C * C + co;
    const float* aj = A + (r0 + j * d) * g.lda;
#pragma unroll 4
    for (int ci = 0; ci < C; ++ci) {
      const float4 wv =
          __ldg(reinterpret_cast<const float4*>(wj + (size_t)ci * C));
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const float av = aj[q * g.lda + ci];
        acc[q][0] = fmaf(av, wv.x, acc[q][0]);
        acc[q][1] = fmaf(av, wv.y, acc[q][1]);
        acc[q][2] = fmaf(av, wv.z, acc[q][2]);
        acc[q][3] = fmaf(av, wv.w, acc[q][3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    const int t = t0 + r0 + q;
    if (t >= T) break;
    const size_t off = batch + (size_t)t * C + co;
    float4 o = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
    if (residual != nullptr) {
      const float4 rv = *reinterpret_cast<const float4*>(residual + off);
      o.x += rv.x;
      o.y += rv.y;
      o.z += rv.z;
      o.w += rv.w;
    }
    *reinterpret_cast<float4*>(y + off) = o;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

// x, residual (nullable), y: [B, T, C]; alpha, bias: [C]; w: [k, C, C]
// ([tap][in][out]). Needs C % 4 == 0, odd k, d >= 1, 16-byte aligned
// w, bias, residual and y. Returns the CUDA error code (0 on success).
extern "C" int amp_aa_conv(const float* x, const float* alpha, const float* w,
                           const float* bias, const float* residual, float* y,
                           int B, int T, int C, int k, int d, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % RC != 0 || k <= 0 || k % 2 == 0 ||
      d <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(bias) || !aligned16(y) ||
      (residual != nullptr && !aligned16(residual)))
    return (int)cudaErrorMisalignedAddress;
  const Tile g = make_tile(C, k, d);
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      aa_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + g.tt - 1) / g.tt, (C + g.cot - 1) / g.cot, B);
  aa_conv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, alpha, w, bias, residual, y, T, C, k, d);
  return (int)cudaGetLastError();
}
