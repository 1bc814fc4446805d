// Kernel K3: a whole BigVGAN AMPBlock -- a chain of AMPLayers of one kernel
// size, y = L_n(...L_1(x)), L_i(x) = x + conv2_i(AA2_i(conv1_i(AA1_i(x)))) --
// in one launch, float32, [B, T, C] channel-last.
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_block with more than
// one layer (its chained form). The block computes the layers run one after
// another (the float32 K2, amp_layer_tc.cu, whose 3xTF32 mix sums in
// another order, so the two agree within float32 rounding), with the same
// edge rules:
// every anti-aliased snake reads its input with sample indices clamped to
// [0, T) (the host edge pad for layer 0, "ro" between layers, and conv1's
// output replicated before AA2), the 2x-rate snake values are clamped to
// [0, 2T), and both convs read zeros outside [0, T) ("zo").
//
// Bound: the channel mix (2*k*C^2 flops per sample and conv) outweighs the
// bytes, so operations bound it; this version runs it on the CUDA cores in
// float32 (no tensor cores). Chaining saves the HBM round trips of the
// layer outputs and five of K2's six launches, and pays for it with the
// halo: a tile of TT output samples recomputes every stage over TT plus the
// summed reach of the later stages, sum over layers of
// 6 + (k-1)/2*d + 6 + (k-1)/2 samples on each side (48, 72, 96 samples for
// k = 3, 7, 11 at dilations 1, 3, 5).
//
// Design: a block owns one time tile (persistent: it walks over tiles) and
// all C channels. It keeps two [TT + 2*halo, C] float32 buffers -- X, the
// running layer output, and H, conv1's output -- in shared memory where both
// fit the 227 KB opt-in, else in a per-block slot of a global scratch
// (at most 32 MB in all, so it stays in the 50 MB L2). Each layer is two
// stages, aa_conv(X -> H) and aa_conv(H -> X, + residual); each stage narrows
// the valid row range by its reach, and only rows whose sample lies in
// [0, T) are computed. aa_conv works in chunks of output rows: it builds
// A = AA(src) over the chunk plus the conv halo for all C channels in shared
// memory (32 channels at a time through staged src rows and 2x-rate snake
// values), then each thread accumulates a 4 x 4 tile of (rows, output
// channels) over (tap, input channel) with float4 weight loads from L2.
// Only the tile's own TT samples are written to y.
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RT = 4;             // conv output rows per thread
constexpr int RC = 4;             // conv output channels per thread (float4)
constexpr int CW = 32;            // channels per AA staging chunk
constexpr int MAX_LAYERS = 3;
constexpr int AA_REACH = 6;       // AA output t reads samples t-6 .. t+5
constexpr int MIN_SMEM_TT = 64;   // smallest tile worth the shared-memory path
constexpr int GLOBAL_TT = 64;     // tile of the global-scratch path
constexpr int MAX_TT = 512;
constexpr size_t SMEM_MAX = 232448;             // sm_90 opt-in per block
constexpr size_t SCRATCH_MAX = size_t(32) << 20;  // global scratch, bytes

struct Layer {
  const float* a1;
  const float* w1;  // [k][C_in][C_out]
  const float* b1;
  const float* a2;
  const float* w2;
  const float* b2;
  int d;            // conv1 dilation
};

struct Chain {
  Layer layer[MAX_LAYERS];
  int n_layers;
};

struct Plan {
  int C, k, halo;
  int tt;        // output samples per tile
  int n;         // buffer rows: tt + 2 * halo
  int ld;        // buffer and A row stride: C + 1 (rows 4 apart in banks)
  int rows;      // conv output rows per pass: THREADS * RT * RC / C
  int na_max;    // A staging rows: rows + 2 * (largest conv halo)
  bool global;   // X and H live in global scratch
  size_t stage_bytes;  // A, Xs, S staging in shared memory
  size_t buf_bytes;    // X and H
};

inline Plan make_plan(int C, int k, const int* dils, int n_layers) {
  Plan g;
  g.C = C;
  g.k = k;
  g.halo = 0;
  int dmax = 1;
  for (int l = 0; l < n_layers; ++l) {
    g.halo += 2 * AA_REACH + (k - 1) / 2 * (dils[l] + 1);
    dmax = dils[l] > dmax ? dils[l] : dmax;
  }
  g.ld = C + 1;
  g.rows = THREADS * RT * RC / C;
  g.na_max = g.rows + 2 * ((k - 1) / 2 * dmax);
  g.stage_bytes = sizeof(float) * ((size_t)g.na_max * g.ld +
                                   (size_t)(g.na_max + 2 * AA_REACH) * CW +
                                   (size_t)(2 * g.na_max + 10) * CW);
  g.global = true;
  g.tt = GLOBAL_TT;
  for (int tt = MAX_TT; tt >= MIN_SMEM_TT; tt -= 32) {
    const size_t buf = sizeof(float) * 2 * (size_t)(tt + 2 * g.halo) * g.ld;
    if (g.stage_bytes + buf <= SMEM_MAX) {
      g.global = false;
      g.tt = tt;
      break;
    }
  }
  g.n = g.tt + 2 * g.halo;
  g.buf_bytes = sizeof(float) * 2 * (size_t)g.n * g.ld;
  return g;
}

// One stage: dst[r] = conv_d(AA_alpha(src))[r] + bias (+ dst[r] when
// `residual`) for buffer rows r in [lo, hi) whose sample base + r lies in
// [0, T). src is read at samples clamped to [0, T); every row it is read at
// lies in [lo - hc - 6, hi + hc + 6), which the caller guarantees is valid.
__device__ void aa_conv(const float* src, float* dst, bool residual,
                        const float* __restrict__ alpha,
                        const float* __restrict__ w,
                        const float* __restrict__ bias, int d, int lo, int hi,
                        int base, int T, const Plan& g, float* A, float* Xs,
                        float* S) {
  const int tid = threadIdx.x;
  const int C = g.C;
  const int hc = (g.k - 1) / 2 * d;
  lo = max(lo, -base);
  hi = min(hi, T - base);
  const int cc = tid % CW;
  const int ry = tid / CW;
  constexpr int RSTRIDE = THREADS / CW;
  const int ncg = C / RC;
  const int cg = tid % ncg;
  const int tg = tid / ncg;
  const int co = cg * RC;
  const int rr = tg * RT;
  for (int r0 = lo; r0 < hi; r0 += g.rows) {
    const int nrow = min(g.rows, hi - r0);
    const int na = nrow + 2 * hc;
    const int a0 = base + r0 - hc;  // sample of A row 0
    const int x0 = a0 - AA_REACH;   // sample of Xs row 0
    const int m0 = 2 * a0 - 5;      // 2x-rate index of S row 0
    // Phase 1: A[l][c] = AA(src)(a0 + l) for a0 + l in [0, T), else 0.
    for (int c0 = 0; c0 < C; c0 += CW) {
      const int c = c0 + cc;
      for (int l = ry; l < na + 2 * AA_REACH; l += RSTRIDE) {
        const int p = min(max(x0 + l, 0), T - 1);
        Xs[l * CW + cc] = src[(size_t)(p - base) * g.ld + c];
      }
      __syncthreads();
      const float a = expf(alpha[c]);
      const float inv_a = 1.f / (a + 1e-9f);
      for (int j = ry; j < 2 * na + 10; j += RSTRIDE) {
        const int m = min(max(m0 + j, 0), 2 * T - 1);
        S[j * CW + cc] = ptts::snake(ptts::up2_at(Xs + cc, CW, x0, m), a,
                                     inv_a);
      }
      __syncthreads();
      for (int l = ry; l < na; l += RSTRIDE) {
        const int p = a0 + l;
        // S rows for 2p-5+n start at local row 2p-5 - m0 = 2l
        A[l * g.ld + c] =
            (p >= 0 && p < T) ? ptts::down2_at(S + 2 * l * CW + cc, CW) : 0.f;
      }
      // the next chunk's first __syncthreads orders these S reads before S
      // is rewritten
    }
    __syncthreads();

    // Phase 2: dst[r0 + rr + q][co + i] = bias + sum_j sum_ci
    //          w[j][ci][co + i] * A[rr + q + j*d][ci] (+ residual).
    if (rr < nrow) {
      const float4 bv = *reinterpret_cast<const float4*>(bias + co);
      float acc[RT][RC];
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        acc[q][0] = bv.x;
        acc[q][1] = bv.y;
        acc[q][2] = bv.z;
        acc[q][3] = bv.w;
      }
      for (int j = 0; j < g.k; ++j) {
        const float* wj = w + (size_t)j * C * C + co;
        const float* aj = A + (rr + j * d) * g.ld;
#pragma unroll 4
        for (int ci = 0; ci < C; ++ci) {
          const float4 wv =
              __ldg(reinterpret_cast<const float4*>(wj + (size_t)ci * C));
#pragma unroll
          for (int q = 0; q < RT; ++q) {
            const float av = aj[q * g.ld + ci];
            acc[q][0] = fmaf(av, wv.x, acc[q][0]);
            acc[q][1] = fmaf(av, wv.y, acc[q][1]);
            acc[q][2] = fmaf(av, wv.z, acc[q][2]);
            acc[q][3] = fmaf(av, wv.w, acc[q][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        if (rr + q >= nrow) break;
        float* o = dst + (size_t)(r0 + rr + q) * g.ld + co;
#pragma unroll
        for (int i = 0; i < RC; ++i) o[i] = acc[q][i] + (residual ? o[i] : 0.f);
      }
    }
    __syncthreads();  // A is rebuilt by the next chunk; dst is read next
  }
}

__global__ void __launch_bounds__(THREADS)
amp_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                 float* scratch, Chain chain, Plan g, int T, int tiles_t,
                 int n_tiles) {
  extern __shared__ float smem[];
  float* A = smem;                                      // [na_max][ld]
  float* Xs = A + (size_t)g.na_max * g.ld;              // [na_max + 12][CW]
  float* S = Xs + (size_t)(g.na_max + 2 * AA_REACH) * CW;  // [2na_max+10][CW]
  float* X = g.global ? scratch + (size_t)blockIdx.x * 2 * g.n * g.ld
                      : S + (size_t)(2 * g.na_max + 10) * CW;  // [n][ld]
  float* H = X + (size_t)g.n * g.ld;                             // [n][ld]
  const int C = g.C;
  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t batch = (size_t)(tile / tiles_t) * T * C;
    const int t0 = (tile % tiles_t) * g.tt;
    const int base = t0 - g.halo;  // sample of buffer row 0

    // X rows whose samples lie in [0, T); the others are never read
    const int r_lo = max(0, -base);
    const int r_hi = min(g.n, T - base);
    for (int e = tid; e < (r_hi - r_lo) * C; e += THREADS) {
      const int r = r_lo + e / C;
      const int c = e % C;
      X[(size_t)r * g.ld + c] = x[batch + (size_t)(base + r) * C + c];
    }
    __syncthreads();

    int lo = 0, hi = g.n;
    for (int l = 0; l < chain.n_layers; ++l) {
      const Layer& L = chain.layer[l];
      const int reach1 = AA_REACH + (g.k - 1) / 2 * L.d;
      lo += reach1;
      hi -= reach1;
      aa_conv(X, H, false, L.a1, L.w1, L.b1, L.d, lo, hi, base, T, g, A, Xs,
              S);
      const int reach2 = AA_REACH + (g.k - 1) / 2;
      lo += reach2;
      hi -= reach2;
      aa_conv(H, X, true, L.a2, L.w2, L.b2, 1, lo, hi, base, T, g, A, Xs, S);
    }
    // here lo == halo and hi == halo + tt: the tile's own samples
    const int o_hi = min(hi, T - base);
    for (int e = tid; e < (o_hi - lo) * C; e += THREADS) {
      const int r = lo + e / C;
      const int c = e % C;
      y[batch + (size_t)(base + r) * C + c] = X[(size_t)r * g.ld + c];
    }
    __syncthreads();  // X is reloaded for the next tile
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

bool valid(int B, int T, int C, int k, const int* dils, int n_layers) {
  if (B <= 0 || T <= 0 || C <= 0 || C % CW != 0 || C > 256 || k <= 0 ||
      k % 2 == 0 || n_layers < 1 || n_layers > MAX_LAYERS)
    return false;
  for (int l = 0; l < n_layers; ++l)
    if (dils[l] < 1) return false;
  return true;
}

// Shared memory per block, grid size and global scratch (floats) of a plan.
cudaError_t launch_shape(const Plan& g, int n_tiles, size_t* smem, int* grid,
                         long long* scratch_floats) {
  *smem = g.stage_bytes + (g.global ? 0 : g.buf_bytes);
  cudaError_t err = cudaFuncSetAttribute(
      amp_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)*smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, amp_block_kernel, THREADS, *smem);
  if (err != cudaSuccess) return err;
  long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g.global) {
    const long long fit = (long long)(SCRATCH_MAX / g.buf_bytes);
    cap = cap < fit ? cap : fit;
  }
  if (cap < 1) cap = 1;
  *grid = (int)(n_tiles < cap ? n_tiles : cap);
  *scratch_floats =
      g.global ? (long long)*grid * (long long)(g.buf_bytes / sizeof(float))
               : 0;
  return cudaSuccess;
}

}  // namespace

// Floats of global scratch amp_block needs for this shape (0 when X and H fit
// in shared memory), or a negative CUDA error code.
extern "C" long long amp_block_scratch_floats(int B, int T, int C, int k,
                                              const int* dils, int n_layers) {
  if (!valid(B, T, C, k, dils, n_layers))
    return -(long long)cudaErrorInvalidValue;
  const Plan g = make_plan(C, k, dils, n_layers);
  const int n_tiles = B * ((T + g.tt - 1) / g.tt);
  size_t smem;
  int grid;
  long long floats;
  const cudaError_t err = launch_shape(g, n_tiles, &smem, &grid, &floats);
  return err == cudaSuccess ? floats : -(long long)err;
}

// x, y: [B, T, C]; scratch: amp_block_scratch_floats() floats (may be null
// when that is 0); layer_ptrs: host array of 6 device pointers per layer,
// (alpha1, w1, b1, alpha2, w2, b2), w* in [k][C_in][C_out] layout; dils: host
// array of the layers' conv1 dilations. Needs C a multiple of 32 up to 256,
// odd k, 1-3 layers, 16-byte aligned w*, b* and y. Returns the CUDA error
// code (0 on success).
extern "C" int amp_block(const float* x, float* y, float* scratch,
                         long long scratch_floats,
                         const void* const* layer_ptrs, const int* dils,
                         int n_layers, int B, int T, int C, int k,
                         void* stream) {
  if (!valid(B, T, C, k, dils, n_layers))
    return (int)cudaErrorInvalidValue;
  Chain chain;
  chain.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    const void* const* p = layer_ptrs + 6 * l;
    chain.layer[l] = Layer{(const float*)p[0], (const float*)p[1],
                           (const float*)p[2], (const float*)p[3],
                           (const float*)p[4], (const float*)p[5], dils[l]};
    for (int i = 0; i < 6; ++i)
      if (p[i] == nullptr || ((i % 3 != 0) && !aligned16(p[i])))
        return (int)cudaErrorMisalignedAddress;
  }
  if (!aligned16(y)) return (int)cudaErrorMisalignedAddress;
  const Plan g = make_plan(C, k, dils, n_layers);
  const int tiles_t = (T + g.tt - 1) / g.tt;
  const int n_tiles = B * tiles_t;
  size_t smem;
  int grid;
  long long need;
  cudaError_t err = launch_shape(g, n_tiles, &smem, &grid, &need);
  if (err != cudaSuccess) return (int)err;
  if (scratch_floats < need || (need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  amp_block_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, scratch, chain, g, T, tiles_t, n_tiles);
  return (int)cudaGetLastError();
}
