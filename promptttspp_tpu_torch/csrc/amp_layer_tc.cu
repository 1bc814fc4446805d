// Kernel K2-bf16: one BigVGAN AMPLayer, y = x + conv2(AA2(conv1(AA1(x)))),
// with the channel mix on the tensor cores: bf16 operands, float32
// accumulation. [B, T, C] channel-last float32 in and out, as two launches
// of one kernel, like the float32 K2 (amp_layer.cu):
//
//   aa_conv_tc(x, alpha1, w1, b1, d, residual = none) -> h
//   aa_conv_tc(h, alpha2, w2, b2, 1, residual = x)    -> y
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer with
// mxu_bf16=True, the conv_precision="default" path of the JAX AMPLayer
// (vocoders/bigvgan.py:131-139): its channel-mix matmuls take bf16
// operands with float32 accumulation (amp.py:263-273). Here the two
// operands of the mix, AA's output and the conv weights, are rounded to
// bf16 (round to nearest even); AA, bias, residual and the sums stay
// float32. (At C < 128 the TPU kernel also runs AA's FIRs on the MXU in
// bf16; this kernel keeps them in float32.) The edge rules are
// amp_layer.cu's: AA clamps its input to [0, T), the conv reads zeros
// outside [0, T).
//
// Bound on an H100 SXM: per request (36 layers, 640 frames) the mix is
// ~2.6e11 flops, 0.26 ms at 989 TFLOP/s of bf16; AA ~2.2e10 flops of
// float32, 0.33 ms at 67 TFLOP/s; x and y ~1 GB, 0.30 ms at 3.35 TB/s. So
// once the mix is on the tensor cores, AA on the CUDA cores and the bytes
// bound it about equally.
//
// Design: a block owns TT output samples and, up to C = 255, every output
// channel, so AA is computed once per sample and tile (the float32 kernel
// recomputes it for each 64-channel output tile, 4x at C = 256). From
// C = 256 on, a block owns 128 output channels: at C = 256, T = 3840 one
// block per 64-sample tile would leave 72 of 132 SMs idle, and two blocks
// that each compute AA for their tile measured faster (0.379 against
// 0.474 ms for the stage's nine first launches on an H100 SXM at 700 W,
// promptttspp_tpu_torch/tools/k2_variants.py).
// Phase 1 builds A = AA(x) over the TT + 2*hc samples the convolution
// reads, all C channels, in shared memory as bf16 (rows padded by 16
// bytes, so ldmatrix reads 8 rows without bank conflicts; channels
// C..CP-1 zero). A thread computes a run of R consecutive samples of one
// channel from registers: it loads the R + 10 inputs the run needs, forms
// the 2R + 10 2x-rate Snake values one at a time and adds each into the up
// to six outputs it feeds. Shared memory then holds only A and the weight
// stages, and phase 1 needs no barrier (the float32 kernel stages x and
// the 2x-rate values in shared memory, channel chunk by channel chunk).
// Phase 2 is an implicit GEMM, out[TT, C] = sum_j A[j*d : j*d + TT, :] @ W_j:
// tap j's A operand is the row offset j*d into the tile, with no im2col
// copy. The weights, bf16 in [k, NP, CP] ([tap][out][in], zero-padded),
// stream through shared memory in K chunks of KC input channels x BN
// output channels, NSTAGE chunks deep, with cp.async; the first chunks are
// in flight during phase 1. Eight warps each hold an (MT*16) x (NT*8)
// float32 accumulator in registers and issue mma.sync.m16n8k16 bf16. The
// sum over (tap, chunk) runs in one fixed order with no split-K and no
// atomics, so every output is summed the same way whatever its tile: the
// kernel is deterministic. The epilogue adds the bias and, in the second
// launch, the residual.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int R = 16;      // AA samples per thread run
constexpr int NSTAGE = 3;  // weight chunks in shared memory

struct Tile {
  int cp;       // C rounded up to 16: the GEMM's K (and A's columns)
  int wn;       // output channels per warp and pass (NT * 8)
  int warps_n;  // warps across output channels
  int mt;       // m16 tiles per warp
  int tt;       // output samples per block
  int bn;       // output channels per pass: warps_n * wn
  int np;       // weight rows (output channels) padded to whole passes
                // of bn, one pass per grid row (blockIdx.y)
  int kc;       // input channels per staged weight chunk
  int hc;       // conv halo: (k - 1) / 2 * d
  int na;       // A rows: tt + 2 * hc
  int lda;      // A row stride in bf16 (cp + 8)
  int ldb;      // staged weight row stride in bf16 (kc + 8)
};

__host__ __device__ inline Tile make_tile(int C, int k, int d) {
  Tile g;
  g.cp = (C + 15) / 16 * 16;
  g.wn = g.cp < 64 ? g.cp : (g.cp >= 256 ? 32 : 64);
  const int nw = g.cp / g.wn;
  g.warps_n = nw >= 4 ? 4 : (nw >= 2 ? 2 : 1);
  g.mt = g.cp >= 128 ? 2 : 1;
  g.tt = (WARPS / g.warps_n) * 16 * g.mt;
  g.bn = g.warps_n * g.wn;
  g.np = (g.cp + g.bn - 1) / g.bn * g.bn;
  g.kc = (g.cp % 64 == 0 && g.cp <= 256) ? 64 : (g.cp % 32 == 0 ? 32 : 16);
  g.hc = (k - 1) / 2 * d;
  g.na = g.tt + 2 * g.hc;
  g.lda = g.cp + 8;
  g.ldb = g.kc + 8;
  return g;
}

inline size_t smem_bytes(const Tile& g) {
  return 2 * ((size_t)g.na * g.lda + (size_t)NSTAGE * g.bn * g.ldb);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage s of this block's weight stream (tap j = s / nkc, input chunk
// c = s % nkc of pass p), if it exists, into buffer s % NSTAGE:
// W[j][p*bn + n][c*KC + i] -> Bs[n][i] for n < bn, i < KC. Always commits
// one cp.async group.
template <int KC>
__device__ __forceinline__ void load_b(const __nv_bfloat16* __restrict__ w,
                                       __nv_bfloat16* Bs, const Tile& g,
                                       int k, int p, int s, int tid) {
  const int nkc = g.cp / KC;
  if (s < k * nkc) {
    const int j = s / nkc;
    const int c = s % nkc;
    const __nv_bfloat16* src =
        w + ((size_t)j * g.np + (size_t)p * g.bn) * g.cp + c * KC;
    __nv_bfloat16* dst = Bs + (s % NSTAGE) * g.bn * g.ldb;
    constexpr int PER_ROW = KC / 8;  // 16-byte pieces per row
    for (int i = tid; i < g.bn * PER_ROW; i += THREADS) {
      const int n = i / PER_ROW;
      const int q = i % PER_ROW;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + n * g.ldb + q * 8)),
                   "l"(src + (size_t)n * g.cp + q * 8));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The 2x-rate Snake value at m (in [0, 2T)) of channel c, from x with edge
// clamping: ptts::up2_at's sums, read from device memory.
__device__ __forceinline__ float snake_at(const float* __restrict__ xc, int C,
                                          int T, int m, float a,
                                          float inv_a) {
  const int q = m >> 1;
  const int o = (m & 1) ? -2 : -3;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc = fmaf(ptts::kFir[2 * i + (m & 1)],
               xc[(size_t)min(max(q + o + i, 0), T - 1) * C], acc);
  return ptts::snake(2.f * acc, a, inv_a);
}

// At MT = 1 (C < 128) at most 85 registers, so that three blocks share an
// SM and one block's AA overlaps another's GEMM; at MT = 2 at most 128.
template <int MT, int NT, int KC>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 3 : 2)
aa_conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const __nv_bfloat16* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ y,
                  int T, int C, int k, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g = make_tile(C, k, d);
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [na][lda]
  __nv_bfloat16* Bs = A + (size_t)g.na * g.lda;  // NSTAGE x [bn][ldb]
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * g.tt;
  const float* xb = x + (size_t)blockIdx.z * T * C;  // this batch row
  const int nkc = g.cp / KC;
  const int pass = blockIdx.y;  // output channels pass * bn + [0, bn)

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s)  // in flight during phase 1
    load_b<KC>(w, Bs, g, k, pass, s, tid);

  // Phase 1: A[l][c] = bf16(AA(x)[a0 + l][c]) for a0 + l in [0, T), else
  // 0. Run of A rows l0 .. l0 + R - 1 (samples p0 ..): it reads 2x-rate
  // values m = 2*p0 - 5 + jj, jj < 2R + 10, whose up-FIRs read x samples
  // p0 - 5 + ii, ii < R + 10 (xw, clamped). Output r sums
  // kFir[n] * s[2r + n], n = 0..11, in ptts::down2_at's order; an m
  // outside [0, 2T) takes the value at the nearest end.
  const int a0 = t0 - g.hc;  // sample of A row 0
  const int n_runs = (g.na + R - 1) / R;
  for (int item = tid; item < C * n_runs; item += THREADS) {
    const int c = item % C;
    const int l0 = (item / C) * R;
    const int p0 = a0 + l0;
    __nv_bfloat16* Ac = A + l0 * g.lda + c;
    if (p0 + R <= 0 || p0 >= T) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (l0 + r < g.na) Ac[r * g.lda] = __float2bfloat16_rn(0.f);
      continue;
    }
    const float* xc = xb + c;
    const float a = expf(alpha[c]);
    const float inv_a = 1.f / (a + 1e-9f);
    float xw[R + 10];
#pragma unroll
    for (int i = 0; i < R + 10; ++i)
      xw[i] = xc[(size_t)min(max(p0 - 5 + i, 0), T - 1) * C];
    const int m0 = 2 * p0 - 5;
    const bool edge = m0 < 0 || m0 + 2 * R + 9 > 2 * T - 1;
    float s_lo = 0.f, s_hi = 0.f;
    if (edge) {
      s_lo = snake_at(xc, C, T, 0, a, inv_a);
      s_hi = snake_at(xc, C, T, 2 * T - 1, a, inv_a);
    }
    float out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 2 * R + 10; ++jj) {
      // m = m0 + jj is odd for even jj: taps kFir[2i + 1] from x[q - 2]
      float u = 0.f;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        u = fmaf(ptts::kFir[2 * i + (jj % 2 == 0 ? 1 : 0)], xw[jj / 2 + i], u);
      float s = ptts::snake(2.f * u, a, inv_a);
      if (edge) {
        const int m = m0 + jj;
        s = m < 0 ? s_lo : (m > 2 * T - 1 ? s_hi : s);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = jj - 2 * r;
        if (n >= 0 && n < 12) out[r] = fmaf(ptts::kFir[n], s, out[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (l0 + r < g.na)
        Ac[r * g.lda] =
            __float2bfloat16_rn((p >= 0 && p < T) ? out[r] : 0.f);
    }
  }
  if (g.cp > C) {  // zero K padding
    const int pad = g.cp - C;
    for (int i = tid; i < g.na * pad; i += THREADS)
      A[(i / pad) * g.lda + C + i % pad] = __float2bfloat16_rn(0.f);
  }

  // Phase 2: out[t0 + r][co] = sum_j sum_ci A[r + j*d][ci] * W[j][co][ci].
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = (warp / g.warps_n) * 16 * MT;
  const int col0 = (warp % g.warps_n) * NT * 8;
  // ldmatrix row addresses: A rows (lane & 15), k half (lane >> 4); B
  // output channels (lane & 7) + 8 * (lane >> 4), k half (lane >> 3) & 1
  const uint32_t a_base =
      smem_addr(A + (row0 + (lane & 15)) * g.lda + (lane >> 4) * 8);
  const uint32_t b_base = smem_addr(
      Bs + (col0 + (lane & 7) + ((lane >> 4) << 3)) * g.ldb +
      ((lane >> 3) & 1) * 8);
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  int s = 0;
  for (int j = 0; j < k; ++j) {
    for (int c = 0; c < nkc; ++c, ++s) {
      // stage s has landed once at most NSTAGE - 2 newer groups pend
      asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2));
      // stage s (and, at s = 0, A) visible to all; every warp is done with
      // stage s - 1, whose buffer the next load refills
      __syncthreads();
      load_b<KC>(w, Bs, g, k, pass, s + NSTAGE - 1, tid);
      const uint32_t b_stage = b_base + 2 * (s % NSTAGE) * g.bn * g.ldb;
      const uint32_t a_tap = a_base + 2 * (j * d * g.lda + c * KC);
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(af[m], a_tap + 2 * (m * 16 * g.lda + ks * 16));
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_stage + 2 * (n * 16 * g.ldb + ks * 16));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * n], af[m], bf[0], bf[1]);
            mma_bf16(acc[m][2 * n + 1], af[m], bf[2], bf[3]);
          }
        }
      }
    }
  }
  // epilogue: fragment element (m, n, e) is row (lane >> 2) + 8 * (e >> 1),
  // column 2 * (lane & 3) + (e & 1) of its 16 x 8 tile
  const size_t batch = (size_t)blockIdx.z * T * C;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int co = pass * g.bn + col0 + n * 8 + 2 * (lane & 3);
    if (co >= C) continue;
    const float2 bv = *reinterpret_cast<const float2*>(bias + co);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + row0 + m * 16 + (lane >> 2) + 8 * h;
        if (t >= T) continue;
        const size_t off = batch + (size_t)t * C + co;
        float2 o = make_float2(acc[m][n][2 * h] + bv.x,
                               acc[m][n][2 * h + 1] + bv.y);
        if (residual != nullptr) {
          const float2 rv = *reinterpret_cast<const float2*>(residual + off);
          o.x += rv.x;
          o.y += rv.y;
        }
        *reinterpret_cast<float2*>(y + off) = o;
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <int MT, int NT, int KC>
int launch(const Tile& g, const float* x, const float* alpha,
           const __nv_bfloat16* w, const float* bias, const float* residual,
           float* y, int B, int T, int C, int k, int d, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      aa_conv_tc_kernel<MT, NT, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + g.tt - 1) / g.tt, g.np / g.bn, B);
  aa_conv_tc_kernel<MT, NT, KC><<<grid, THREADS, smem, stream>>>(
      x, alpha, w, bias, residual, y, T, C, k, d);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows (output channels) of the bf16 weight layout [k, NP, CP] for C
// channels: the launcher's tiling pads them to whole passes.
extern "C" int amp_tc_weight_rows(int C) { return make_tile(C, 1, 1).np; }

// Columns (input channels) of the bf16 weight layout: C rounded up to 16.
extern "C" int amp_tc_weight_cols(int C) { return make_tile(C, 1, 1).cp; }

// x, residual (nullable), y: [B, T, C] float32; alpha, bias: [C] float32;
// w: bf16 [k, NP, CP] ([tap][out][in], zero beyond C; NP and CP from the two
// functions above). Needs C % 4 == 0, odd k, d >= 1, 16-byte aligned w,
// bias, residual and y. Returns the CUDA error code (0 on success).
extern "C" int amp_aa_conv_tc(const float* x, const float* alpha,
                              const void* w, const float* bias,
                              const float* residual, float* y, int B, int T,
                              int C, int k, int d, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || C % 4 != 0 || k <= 0 || k % 2 == 0 ||
      d <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(bias) || !aligned16(y) ||
      (residual != nullptr && !aligned16(residual)))
    return (int)cudaErrorMisalignedAddress;
  const Tile g = make_tile(C, k, d);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto st = (cudaStream_t)stream;
#define AMP_TC_CASE(MT_, NT_, KC_)                                         \
  if (g.mt == MT_ && g.wn == 8 * NT_ && g.kc == KC_)                       \
    return launch<MT_, NT_, KC_>(g, x, alpha, wb, bias, residual, y, B, T, \
                                 C, k, d, st);
  AMP_TC_CASE(2, 4, 64)
  AMP_TC_CASE(2, 4, 32)
  AMP_TC_CASE(2, 4, 16)
  AMP_TC_CASE(2, 8, 64)
  AMP_TC_CASE(2, 8, 32)
  AMP_TC_CASE(2, 8, 16)
  AMP_TC_CASE(1, 8, 64)
  AMP_TC_CASE(1, 8, 32)
  AMP_TC_CASE(1, 8, 16)
  AMP_TC_CASE(1, 6, 16)
  AMP_TC_CASE(1, 4, 32)
  AMP_TC_CASE(1, 2, 16)
#undef AMP_TC_CASE
  return (int)cudaErrorInvalidConfiguration;
}
