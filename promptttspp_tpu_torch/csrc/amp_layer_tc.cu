// Kernel K2: one BigVGAN AMPLayer, y = x + conv2(AA2(conv1(AA1(x)))), with
// the channel mix on the tensor cores, in the two precisions of the JAX
// kernel's mxu_bf16 flag. [B, T, C] channel-last float32 in and out, as two
// launches of one kernel:
//
//   aa_conv_tc(x, alpha1, w1, b1, d, residual = none) -> h
//   aa_conv_tc(h, alpha2, w2, b2, 1, residual = x)    -> y
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer, the JAX
// AMPLayer's fused path (vocoders/bigvgan.py:131-139):
// - Bf16Mix (amp_aa_conv_tc), mxu_bf16=True, conv_precision="default": the
//   mix's two operands, AA's output and the conv weights, are rounded to
//   bf16 (round to nearest even) and multiplied with mma.sync m16n8k16 and
//   float32 accumulation (amp.py:263-273). (At C < 128 the TPU kernel also
//   runs AA's FIRs on the MXU in bf16; this kernel keeps them in float32.)
//   The serving path runs csrc/amp_layer_wgmma.cu for this precision; this
//   mix stays as the yardstick of that kernel's time and output bits.
// - Tf32x3Mix (amp_aa_conv_tf32x3), mxu_bf16=False,
//   conv_precision="highest": the mix to float32 accuracy (3xTF32). Each
//   float32 operand v is split into a TF32 "big" part, v rounded to nearest
//   with 11 significant bits (cvt.rna.tf32.f32), and a "small" remainder
//   v - big, exact in float32; each product is small*big + big*small +
//   big*big, three mma.sync m16n8k8 TF32 with float32 accumulation, the
//   small terms first. What is dropped, small*small and the bits of small
//   below TF32 (the tensor cores read its top 11), is under 2^-21 of the
//   product. This is Hopper's counterpart of the multi-pass bf16 products
//   by which JAX reaches float32 precision on the TPU's matrix unit. The
//   tensor cores do not round their float32 sums to nearest, a bias that
//   would grow over the 3 * k * CP / 8 MMAs of a layer summed into one
//   accumulator, so each weight chunk's products go to a zeroed accumulator
//   that is then added to the running sum in float32 with round to nearest.
//   Both operands are split in registers after each ldmatrix (two
//   instructions a value); the weights come as one float32 plane, so the
//   weight stages' shared memory, ldmatrix reads and cp.async traffic stay
//   those of one float32 copy.
// AA, bias, residual and the sums stay float32 in both. The edge rules are
// those of the JAX kernel (amp.py:231-255, 296-310): AA clamps its input to
// [0, T) (edge replication, which for the second launch is "conv1's output
// replicated before AA2"), the conv reads zeros outside [0, T).
//
// Bound on an H100 SXM: per request (36 layers, 640 frames) the mix is
// ~2.6e11 flops, 0.26 ms at 989 TFLOP/s of bf16 and, as three TF32 passes,
// 1.59 ms at 494.7 TFLOP/s; AA ~2.2e10 flops of float32, 0.33 ms at 67
// TFLOP/s; x and y ~1 GB, 0.30 ms at 3.35 TB/s. So the bf16 kernel is
// bound by AA and the bytes about as much as by the mix, the 3xTF32 one by
// its mix (on the CUDA cores in float32 the same mix would take 4.2 ms).
//
// Design: a block owns TT output samples and, up to C = 255, every output
// channel, so AA is computed once per sample and tile. From C = 256 on, a
// block owns 128 output channels: at C = 256, T = 3840 one block per
// 64-sample tile would leave 72 of 132 SMs idle, and two blocks that each
// compute AA for their tile measured faster for bf16 (0.379 against 0.474
// ms for the stage's nine first launches on an H100 SXM at 700 W,
// promptttspp_tpu_torch/tools/k2_variants.py).
// Phase 1 builds A = AA(x) over the TT + 2*hc samples the convolution
// reads, all C channels, in shared memory in the mix's element type (rows
// padded by 16 bytes, so ldmatrix reads 8 rows without bank conflicts;
// channels C..CP-1 zero). A thread computes a run of R consecutive samples
// of one channel from registers (ptts::aa_run, shared with K1), so phase 1
// needs no staging and no barrier.
// Phase 2 is an implicit GEMM, out[TT, C] = sum_j A[j*d : j*d + TT, :] @ W_j:
// tap j's A operand is the row offset j*d into the tile, with no im2col
// copy. The weights, in [k, NP, CP] ([tap][out][in], zero-padded), stream
// through shared memory in K chunks of KC input channels x BN output
// channels, NSTAGE chunks deep, with cp.async; the first chunks are in
// flight during phase 1. ldmatrix reads 16-byte rows, which hold 8 bf16 or
// 4 float32 values, so one ldmatrix.x4 gives an m16 x 32-byte A fragment
// in either type (the TF32 fragment's element (row, k) lands where the
// mma.m16n8k8 takes it). Eight warps each hold an (MT*16) x (NT*8) float32
// accumulator in registers. The sum over (tap, chunk) runs in one fixed
// order with no split-K and no atomics, so every output is summed the same
// way whatever its tile: the kernel is deterministic. The epilogue adds
// the bias and, in the second launch, the residual.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"
#include "polyops.cuh"

namespace {

using ptts::ldmatrix_x4;
using ptts::mma_bf16;
using ptts::mma_tf32x3;
using ptts::split_tf32;

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;

constexpr int R = 16;       // AA samples per thread run
constexpr int NSTAGE = 3;   // weight chunks in shared memory
constexpr int TWO_PASS_CP = 256;  // from this CP on, output passes of 128

// The mixes: the element type of A and the staged weights, and the tiling
// that make_tile takes from them.
// - MT2_CP: from this CP on a warp takes two m16 tiles. Float32: from
//   C = 256 on, so that at C = 128, T = 19200 the tiles of 64 samples fill
//   the 132 SMs with twice as many blocks.
// - KC64_CP: up to this CP a weight chunk holds 64 input channels where CP
//   allows, else 32 or 16. Float32: 64 only at C = 64, so that three
//   stages fit beside A at C = 256, k = 11, d = 5 (A 118,560 + weights
//   55,296 bytes of the 232,448 a block may use).
// - min_blocks: the blocks per SM that the launch bounds ask for. Bf16:
//   three at MT = 1 (C < 128: at most 85 registers, so that one block's AA
//   overlaps another's GEMM), two at MT = 2. Tf32x3, whose split operands
//   and chunk sums need more registers: three up to NT = 4 (C < 64), two
//   at NT = 8, one at MT = 2 (C >= 256), where shared memory admits no
//   second block.
struct Bf16Mix {
  using Elem = __nv_bfloat16;
  static constexpr bool TF32X3 = false;
  static constexpr int MT2_CP = 128;
  static constexpr int KC64_CP = 256;
  __host__ __device__ static constexpr int min_blocks(int mt, int) {
    return mt == 1 ? 3 : 2;
  }
  static __device__ __forceinline__ Elem from_float(float v) {
    return __float2bfloat16_rn(v);
  }
};

struct Tf32x3Mix {
  using Elem = float;
  static constexpr bool TF32X3 = true;
  static constexpr int MT2_CP = 256;
  static constexpr int KC64_CP = 64;
  __host__ __device__ static constexpr int min_blocks(int mt, int nt) {
    return mt == 2 ? 1 : (nt <= 4 ? 3 : 2);
  }
  static __device__ __forceinline__ Elem from_float(float v) { return v; }
};

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
  int lda;      // A row stride in elements (cp + 16 bytes)
  int ldb;      // staged weight row stride in elements (kc + 16 bytes)
};

// The output passes, and so the weight layout, are the same for both mixes.
template <class Mix>
__host__ __device__ inline Tile make_tile(int C, int k, int d) {
  constexpr int es = sizeof(typename Mix::Elem);
  Tile g;
  g.cp = (C + 15) / 16 * 16;
  g.wn = g.cp < 64 ? g.cp : (g.cp >= TWO_PASS_CP ? 32 : 64);
  const int nw = g.cp / g.wn;
  g.warps_n = nw >= 4 ? 4 : (nw >= 2 ? 2 : 1);
  g.mt = g.cp >= Mix::MT2_CP ? 2 : 1;
  g.tt = (WARPS / g.warps_n) * 16 * g.mt;
  g.bn = g.warps_n * g.wn;
  g.np = (g.cp + g.bn - 1) / g.bn * g.bn;
  g.kc = (g.cp % 64 == 0 && g.cp <= Mix::KC64_CP) ? 64
                                                  : (g.cp % 32 == 0 ? 32 : 16);
  g.hc = (k - 1) / 2 * d;
  g.na = g.tt + 2 * g.hc;
  g.lda = g.cp + 16 / es;
  g.ldb = g.kc + 16 / es;
  return g;
}

template <class Mix>
inline size_t smem_bytes(const Tile& g) {
  return sizeof(typename Mix::Elem) *
         ((size_t)g.na * g.lda + (size_t)NSTAGE * g.bn * g.ldb);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Stage s of this block's weight stream (tap j = s / nkc, input chunk
// c = s % nkc of pass p), if it exists, into buffer s % NSTAGE:
// W[j][p*bn + n][c*KC + i] -> Bs[n][i] for n < bn, i < KC. Always commits
// one cp.async group.
template <class Mix, int KC>
__device__ __forceinline__ void load_b(
    const typename Mix::Elem* __restrict__ w, typename Mix::Elem* Bs,
    const Tile& g, int k, int p, int s, int tid) {
  using Elem = typename Mix::Elem;
  const int nkc = g.cp / KC;
  if (s < k * nkc) {
    const int j = s / nkc;
    const int c = s % nkc;
    constexpr int PIECE = 16 / sizeof(Elem);  // elements per 16 bytes
    constexpr int PER_ROW = KC / PIECE;
    const Elem* src = w + ((size_t)j * g.np + (size_t)p * g.bn) * g.cp +
                      c * KC;
    Elem* dst = Bs + (s % NSTAGE) * g.bn * g.ldb;
    for (int i = tid; i < g.bn * PER_ROW; i += THREADS) {
      const int n = i / PER_ROW;
      const int e = i % PER_ROW;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_addr(dst + n * g.ldb + e * PIECE)),
                   "l"(src + (size_t)n * g.cp + e * PIECE));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <class Mix, int MT, int NT, int KC>
__global__ void __launch_bounds__(THREADS, Mix::min_blocks(MT, NT))
aa_conv_tc_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                  const typename Mix::Elem* __restrict__ w,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ y,
                  int T, int C, int k, int d) {
  using Elem = typename Mix::Elem;
  constexpr int ES = sizeof(Elem);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile g = make_tile<Mix>(C, k, d);
  Elem* A = reinterpret_cast<Elem*>(smem_raw);  // [na][lda]
  Elem* Bs = A + (size_t)g.na * g.lda;  // NSTAGE x [bn][ldb]
  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * g.tt;
  const float* xb = x + (size_t)blockIdx.z * T * C;  // this batch row
  const int nkc = g.cp / KC;
  const int pass = blockIdx.y;  // output channels pass * bn + [0, bn)

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s)  // in flight during phase 1
    load_b<Mix, KC>(w, Bs, g, k, pass, s, tid);

  // Phase 1: A[l][c] = AA(x)[a0 + l][c] for a0 + l in [0, T), else 0, one
  // run of A rows l0 .. l0 + R - 1 (samples p0 ..) per item.
  const int a0 = t0 - g.hc;  // sample of A row 0
  const int n_runs = (g.na + R - 1) / R;
  for (int item = tid; item < C * n_runs; item += THREADS) {
    const int c = item % C;
    const int l0 = (item / C) * R;
    const int p0 = a0 + l0;
    Elem* Ac = A + l0 * g.lda + c;
    if (p0 + R <= 0 || p0 >= T) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (l0 + r < g.na) Ac[r * g.lda] = Mix::from_float(0.f);
      continue;
    }
    const float a = expf(alpha[c]);
    const float inv_a = 1.f / (a + 1e-9f);
    float out[R];
    ptts::aa_run<R>(xb + c, C, T, p0, a, inv_a,
                    [&](int r, float v) { out[r] = v; });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (l0 + r < g.na)
        Ac[r * g.lda] = Mix::from_float((p >= 0 && p < T) ? out[r] : 0.f);
    }
  }
  if (g.cp > C) {  // zero K padding
    const int pad = g.cp - C;
    for (int i = tid; i < g.na * pad; i += THREADS)
      A[(i / pad) * g.lda + C + i % pad] = Mix::from_float(0.f);
  }

  // Phase 2: out[t0 + r][co] = sum_j sum_ci A[r + j*d][ci] * W[j][co][ci].
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = (warp / g.warps_n) * 16 * MT;
  const int col0 = (warp % g.warps_n) * NT * 8;
  // ldmatrix row addresses: A rows (lane & 15), 16-byte half (lane >> 4)
  // of each 32 bytes of K; B output channels (lane & 7) + 8 * (lane >> 4),
  // 16-byte half (lane >> 3) & 1
  const uint32_t a_base =
      smem_addr(A + (row0 + (lane & 15)) * g.lda) + (lane >> 4) * 16;
  const uint32_t b_base =
      smem_addr(Bs + (col0 + (lane & 7) + ((lane >> 4) << 3)) * g.ldb) +
      ((lane >> 3) & 1) * 16;
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
      load_b<Mix, KC>(w, Bs, g, k, pass, s + NSTAGE - 1, tid);
      const uint32_t b_stage = b_base + ES * (s % NSTAGE) * g.bn * g.ldb;
      const uint32_t a_tap = a_base + ES * (j * d * g.lda + c * KC);
      // Tf32x3 sums each chunk's products in `part` and adds it to acc in
      // float32 with round to nearest (see the header).
      float part[MT][NT][4];
      auto& sum = Mix::TF32X3 ? part : acc;
      if constexpr (Mix::TF32X3) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KC * ES / 32; ++ks) {  // 32 bytes of K each
        uint32_t af[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(af[m], a_tap + ES * m * 16 * g.lda + 32 * ks);
        uint32_t af_small[MT][4];
        if constexpr (Mix::TF32X3) {
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(af[m][e], af_small[m][e]);
        }
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          uint32_t bf[4];
          ldmatrix_x4(bf, b_stage + ES * n * 16 * g.ldb + 32 * ks);
          if constexpr (Mix::TF32X3) {
            uint32_t bs[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(bf[e], bs[e]);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_tf32x3(sum[m][2 * n], af[m], af_small[m], bf[0], bf[1],
                         bs[0], bs[1]);
              mma_tf32x3(sum[m][2 * n + 1], af[m], af_small[m], bf[2],
                         bf[3], bs[2], bs[3]);
            }
          } else {
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(sum[m][2 * n], af[m], bf[0], bf[1]);
              mma_bf16(sum[m][2 * n + 1], af[m], bf[2], bf[3]);
            }
          }
        }
      }
      if constexpr (Mix::TF32X3) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
      }
    }
  }
  // epilogue: fragment element (m, n, e) is row (lane >> 2) + 8 * (e >> 1),
  // column 2 * (lane & 3) + (e & 1) of its 16 x 8 tile. co is even, so at
  // an even C the pair (co, co + 1) lies inside the row and is 8-byte
  // aligned; at an odd C it is written as scalars, the second only if
  // co + 1 < C.
  const size_t batch = (size_t)blockIdx.z * T * C;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int co = pass * g.bn + col0 + n * 8 + 2 * (lane & 3);
    if (co >= C) continue;
    const bool pair = (C & 1) == 0;
    const bool second = co + 1 < C;
    const float2 bv =
        pair ? *reinterpret_cast<const float2*>(bias + co)
             : make_float2(bias[co], second ? bias[co + 1] : 0.f);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + row0 + m * 16 + (lane >> 2) + 8 * h;
        if (t >= T) continue;
        const size_t off = batch + (size_t)t * C + co;
        float2 o = make_float2(acc[m][n][2 * h] + bv.x,
                               acc[m][n][2 * h + 1] + bv.y);
        if (pair) {
          if (residual != nullptr) {
            const float2 rv =
                *reinterpret_cast<const float2*>(residual + off);
            o.x += rv.x;
            o.y += rv.y;
          }
          *reinterpret_cast<float2*>(y + off) = o;
        } else {
          if (residual != nullptr) {
            o.x += residual[off];
            if (second) o.y += residual[off + 1];
          }
          y[off] = o.x;
          if (second) y[off + 1] = o.y;
        }
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

template <class Mix, int MT, int NT, int KC>
int launch(const Tile& g, const float* x, const float* alpha,
           const typename Mix::Elem* w, const float* bias,
           const float* residual, float* y, int B, int T, int C, int k, int d,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<Mix>(g);
  cudaError_t err = cudaFuncSetAttribute(
      aa_conv_tc_kernel<Mix, MT, NT, KC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + g.tt - 1) / g.tt, g.np / g.bn, B);
  aa_conv_tc_kernel<Mix, MT, NT, KC><<<grid, THREADS, smem, stream>>>(
      x, alpha, w, bias, residual, y, T, C, k, d);
  return (int)cudaGetLastError();
}

template <class Mix>
int aa_conv(const float* x, const float* alpha, const void* w,
            const float* bias, const float* residual, float* y, int B, int T,
            int C, int k, int d, void* stream) {
  using Elem = typename Mix::Elem;
  if (B <= 0 || T <= 0 || C <= 0 || k <= 0 || k % 2 == 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(bias) || !aligned16(y) ||
      (residual != nullptr && !aligned16(residual)))
    return (int)cudaErrorMisalignedAddress;
  const Tile g = make_tile<Mix>(C, k, d);
  const auto* we = static_cast<const Elem*>(w);
  const auto st = (cudaStream_t)stream;
#define AMP_TC_CASE(MT_, NT_, KC_)                                           \
  if (g.mt == MT_ && g.wn == 8 * NT_ && g.kc == KC_)                         \
    return launch<Mix, MT_, NT_, KC_>(g, x, alpha, we, bias, residual, y, B, \
                                      T, C, k, d, st);
  if constexpr (Mix::KC64_CP >= Mix::MT2_CP) {  // 64-channel chunks at MT = 2
    AMP_TC_CASE(2, 4, 64)
    AMP_TC_CASE(2, 8, 64)
  }
  AMP_TC_CASE(1, 8, 64)
  AMP_TC_CASE(2, 4, 32)
  AMP_TC_CASE(2, 4, 16)
  AMP_TC_CASE(2, 8, 32)
  AMP_TC_CASE(2, 8, 16)
  AMP_TC_CASE(1, 8, 32)
  AMP_TC_CASE(1, 8, 16)
  AMP_TC_CASE(1, 6, 16)
  AMP_TC_CASE(1, 4, 32)
  AMP_TC_CASE(1, 2, 16)
#undef AMP_TC_CASE
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

// Rows (output channels) of the weight layout [k, NP, CP] for C channels,
// the same for both mixes: the launcher's tiling pads them to whole passes.
extern "C" int amp_tc_weight_rows(int C) {
  return make_tile<Bf16Mix>(C, 1, 1).np;
}

// Columns (input channels) of the weight layout: C rounded up to 16.
extern "C" int amp_tc_weight_cols(int C) {
  return make_tile<Bf16Mix>(C, 1, 1).cp;
}

// x, residual (nullable), y: [B, T, C] float32; alpha, bias: [C] float32;
// w: [k, NP, CP] ([tap][out][in], zero beyond C; NP and CP from the
// functions above), bf16 for amp_aa_conv_tc (K2-bf16) and float32 for
// amp_aa_conv_tf32x3 (the float32 K2). Take any C >= 1; need odd k, d >= 1,
// 16-byte aligned w, bias, residual and y. Return the CUDA error code (0 on
// success).
extern "C" int amp_aa_conv_tc(const float* x, const float* alpha,
                              const void* w, const float* bias,
                              const float* residual, float* y, int B, int T,
                              int C, int k, int d, void* stream) {
  return aa_conv<Bf16Mix>(x, alpha, w, bias, residual, y, B, T, C, k, d,
                          stream);
}

extern "C" int amp_aa_conv_tf32x3(const float* x, const float* alpha,
                                  const void* w, const float* bias,
                                  const float* residual, float* y, int B,
                                  int T, int C, int k, int d, void* stream) {
  return aa_conv<Tf32x3Mix>(x, alpha, w, bias, residual, y, B, T, C, k, d,
                            stream);
}
