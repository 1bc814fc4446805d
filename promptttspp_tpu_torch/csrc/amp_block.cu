// Kernel K3: a whole BigVGAN AMPBlock -- a chain of AMPLayers of one kernel
// size, y = L_n(...L_1(x)), L_i(x) = x + conv2_i(AA2_i(conv1_i(AA1_i(x)))) --
// in one launch, [B, T, C] channel-last float32 in and out, with the channel
// mixes on the tensor cores in the two precisions of the JAX kernel's
// mxu_bf16 flag.
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_block (:348, its
// pallas_call :438) with any number of layers. Each layer computes the
// arithmetic of kernel K2 of the same precision, in K2's order, so the
// block's output equals the chain of K2 launches bit for bit:
// - Bf16Path (mxu_bf16=True): AA in float32 (the sums of ptts::aa_run),
//   rounded once to bf16 (round to nearest even) as the mix's A operand;
//   bf16 weights; wgmma.mma_async m64nNk16 with float32 accumulation, both
//   operands read from shared memory, summed over tap j, then input
//   channel, in k16 steps into one accumulator, with no split-K and no
//   atomics: K2-bf16's (amp_layer_wgmma.cu) mix, on its weight layout.
// - Tf32Path (mxu_bf16=False): the float32 K2's 3xTF32 products
//   (amp_layer_tc.cu::Tf32x3Mix) on mma.sync m16n8k8, small*big, big*small,
//   big*big, each weight chunk of KC input channels summed in its own
//   accumulator and added to the running sum in float32, KC as that kernel
//   takes it.
// The bias, then the residual, are added in float32. The edge rules are
// K2's: every AA reads its input with sample indices clamped to [0, T) (the
// block input, conv1's output before AA2, each layer's output before the
// next layer), the convs read zeros outside [0, T).
//
// Bound on an H100 SXM at 700 W, per 640-frame request (its 12 blocks): the
// mixes ~2.6e11 flops, 0.27 ms at 989 TFLOP/s of bf16 and, as three TF32
// passes, 1.59 ms at 494.7 TFLOP/s; AA ~2.2e10 flops of float32, 0.33 ms
// at 67 TFLOP/s; x and y once per block 0.10 ms at 3.35 TB/s. Chaining
// takes the layer outputs' device-memory round trips off the bytes, and
// pays for it with the halo: a tile of TT output samples computes every
// stage over TT plus the summed reach of the later stages, per layer
// 6 + (k-1)/2*d + 6 + (k-1)/2 samples on each side (48, 72, 96 for
// k = 3, 7, 11 at dilations 1, 3, 5).
//
// Design: a block owns one time tile of TT samples and all C channels
// (persistent: it walks over tiles). It keeps two float32 buffers of
// TT + 2*halo rows, X (the running layer output) and H (conv1's output), in
// a per-block slot of a global scratch that the L2 holds, which lets two or
// three blocks share an SM; the float32 path keeps them in shared memory,
// one block per SM, where a tile of SMEM_TT fits beside its other buffers
// (C <= 32 at the flagship's shapes), the one case where that measured
// faster (tools/k3_variants.py). Each layer is two stages,
// aa_conv(X -> H) and aa_conv(H -> X, + X); each narrows the valid row
// range by its reach, only rows whose sample lies in [0, T) are computed,
// and the last stage writes the tile's TT rows straight to y. A stage walks
// its rows in chunks of MR, the rows of the mix's tiling: AA over the chunk
// plus the conv halo, from the source buffer into the A operand in shared
// memory (a run of R samples of one channel per thread, from registers; a
// run reads only rows that the stage before has computed), then for each
// pass of output channels the implicit GEMM (tap j's A operand is the row
// offset j*d), then the epilogue into the destination buffer. A stage's
// weights stay in shared memory where they fit (loaded once per stage),
// else they stream through NSTAGE slots, the first in flight during AA:
// cp.async for the float32 path, one cp.async.bulk per slot completing on
// an mbarrier for bf16. Where the output channels take several passes and
// the tiles do not fill the SMs (the C = 256 stage), a cluster of two
// blocks shares each tile: each computes AA for all channels and half the
// passes, and a cluster barrier ends every stage. The host plan
// (make_plan) takes tiles of up to GLOBAL_TT samples, cut so that they
// fill whole waves of the blocks the SMs hold.
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sync.cuh"
#include "polyops.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptts::ldmatrix_x4;
using ptts::mma_tf32x3;
using ptts::smem_addr;
using ptts::split_tf32;

constexpr int THREADS = 256;      // 8 warps, two warpgroups
constexpr int WARPS = THREADS / 32;
constexpr int R = 16;             // AA samples per thread run
constexpr int NSTAGE = 3;         // weight slots of the ring
constexpr int MAX_LAYERS = 8;     // per launch: the host splits longer chains
constexpr int AA_REACH = 6;       // AA output t reads samples t-6 .. t+5
constexpr int MIN_TT = 64;        // the smallest tile the plan takes
constexpr int GLOBAL_TT = 256;    // the largest tile of the global scratch
constexpr int SMEM_TT = 192;      // the float32 path's shared-memory tile
constexpr size_t SMEM_MAX = 232448;  // an H100 block's shared memory

struct Layer {
  const float* a1;
  const void* w1;  // in the path's weight layout
  const float* b1;
  const float* a2;
  const void* w2;
  const float* b2;
  int d;           // conv1 dilation
};

struct Chain {
  Layer layer[MAX_LAYERS];
  int n_layers;
};

struct Plan {
  int halo;      // the chain's summed reach, samples on each side
  int tt;        // output samples per tile
  int n;         // X and H rows: tt + 2 * halo
  int ldx;       // X and H row stride in floats (even)
  int na;        // A rows: MR + 2 * the largest conv halo
  int global;    // X and H live in the global scratch
  int resident;  // a stage's weights stay in shared memory (one pass)
  int split;     // blocks per tile, a cluster that shares out the passes
  int gk;        // weight chunks per slot
  int abufs;     // A buffers: 2 where the mix runs beside the next AA
  int a_off, x_off, bar_off;  // shared memory: weights at 0, A, bars, X
  int tiles_t;   // tiles per batch row
  int n_tiles;
};

// What a stage reads and writes (see amp_block_kernel).
struct StageArgs {
  const float* src;
  float* dst;
  int dst_ld;
  const float* res;
  const float* alpha;
  const void* w;
  const float* bias;
  int d, lo, hi, t_hi, base;
};

// -- the cluster ---------------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// Every thread of the cluster arrives and waits; what each wrote before,
// to global memory too, is visible to all after.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// -- AA from a buffer ------------------------------------------------------

// The 2x-rate Snake value at m of one channel (ptts::snake_at) from a
// buffer: xc holds the channel's sample `base` at row 0, rows `ld` floats
// apart, and samples are read clamped to [0, t_hi).
__device__ __forceinline__ float snake_rows(const float* xc, int ld, int base,
                                            int t_hi, int m, float a,
                                            float inv_a) {
  const int q = m >> 1;
  const int o = (m & 1) ? -2 : -3;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
    acc = fmaf(ptts::kFir[2 * i + (m & 1)],
               xc[(min(max(q + o + i, 0), t_hi - 1) - base) * ld], acc);
  return ptts::snake(2.f * acc, a, inv_a);
}

// ptts::aa_run from a buffer (xc, ld, base as in snake_rows): emit(r, y)
// with y = AA(x)[p0 + r] for r < R. Samples are read clamped to [0, t_hi)
// with t_hi <= T, the end of the rows the stage before has computed: an
// output whose 12-sample window lies below t_hi, or that reaches T itself
// (t_hi == T), gets K2's value; the others are garbage that the caller
// never uses. An end's edge value (m outside [0, 2T)) is computed only for
// a run that reaches that end, so no read leaves the buffer.
template <class Emit>
__device__ __forceinline__ void aa_run_rows(const float* xc, int ld, int base,
                                            int T, int t_hi, int p0, float a,
                                            float inv_a, Emit&& emit) {
  float xw[R + 10];
#pragma unroll
  for (int i = 0; i < R + 10; ++i)
    xw[i] = xc[(min(max(p0 - 5 + i, 0), t_hi - 1) - base) * ld];
  const int m0 = 2 * p0 - 5;
  const bool lo_edge = m0 < 0;
  const bool hi_edge = m0 + 2 * R + 9 > 2 * T - 1;
  if (lo_edge || hi_edge)
    ptts::aa_run_sums<R, true>(
        xw, a, inv_a, m0, T,
        lo_edge ? snake_rows(xc, ld, base, t_hi, 0, a, inv_a) : 0.f,
        hi_edge ? snake_rows(xc, ld, base, t_hi, 2 * T - 1, a, inv_a) : 0.f,
        emit);
  else
    ptts::aa_run_sums<R, false>(xw, a, inv_a, m0, T, 0.f, 0.f, emit);
}

__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_elem(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The A operand of a chunk: A(l, c) = AA(src)[a0 + l][c] for a0 + l in
// [0, T), else 0, for rows l < na and channels c < C, one run of rows
// l0 .. l0 + R - 1 of one channel per item (amp_layer_tc.cu's phase 1).
// at(l, c) is the element's address; rows are `rstep` elements apart.
template <class Elem, class At>
__device__ __forceinline__ void aa_fill(const StageArgs& a, int ldx, int T,
                                        int C, int a0, int na, int rstep,
                                        At at) {
  const int n_runs = (na + R - 1) / R;
  for (int item = threadIdx.x; item < C * n_runs; item += THREADS) {
    const int c = item % C;
    const int l0 = (item / C) * R;
    const int p0 = a0 + l0;
    Elem* Ac = at(l0, c);
    if (p0 + R <= 0 || p0 >= T) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (l0 + r < na) store_elem(Ac + r * rstep, 0.f);
      continue;
    }
    const float al = expf(a.alpha[c]);
    const float inv_a = 1.f / (al + 1e-9f);
    float out[R];
    aa_run_rows(a.src + c, ldx, a.base, T, a.t_hi, p0, al, inv_a,
                [&](int r, float v) { out[r] = v; });
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int p = p0 + r;
      if (l0 + r < na)
        store_elem(Ac + r * rstep, (p >= 0 && p < T) ? out[r] : 0.f);
    }
  }
}

// out[row][co] = v + bias[co] (+ res[row][co]) for one accumulator pair
// (co, co + 1) of a chunk's row; out and res point at the chunk's row 0,
// rows `ld` and `res_ld` floats apart (res may be out). co is even: at an
// even C the pair is one 8-byte store, at an odd C two scalars, the second
// only if co + 1 < C.
__device__ __forceinline__ void store_pair(float v0, float v1, int row,
                                           int co, int C,
                                           const float* __restrict__ bias,
                                           const float* res, int res_ld,
                                           float* out, int ld) {
  const bool second = co + 1 < C;
  float* o_ptr = out + (size_t)row * ld + co;
  const float* r_ptr =
      res == nullptr ? nullptr : res + (size_t)row * res_ld + co;
  if ((C & 1) == 0) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + co);
    float2 o = make_float2(v0 + bv.x, v1 + bv.y);
    if (r_ptr != nullptr) {
      const float2 rv = *reinterpret_cast<const float2*>(r_ptr);
      o.x += rv.x;
      o.y += rv.y;
    }
    *reinterpret_cast<float2*>(o_ptr) = o;
  } else {
    float o0 = v0 + bias[co];
    float o1 = second ? v1 + bias[co + 1] : 0.f;
    if (r_ptr != nullptr) {
      o0 += r_ptr[0];
      if (second) o1 += r_ptr[1];
    }
    o_ptr[0] = o0;
    if (second) o_ptr[1] = o1;
  }
}

// -- the float32 path: amp_layer_tc.cu's 3xTF32 mix on mma.sync -----------

constexpr int TF32_MT = 2;  // m16 tiles per warp

// The tiling of amp_layer_tc.cu::Tf32x3Mix without the conv halo, which
// changes from stage to stage here, with two m16 tiles per warp at every C
// (measured faster for K3 than one: promptttspp_tpu_torch/tools/
// k3_variants.py, tf32_mt1) and gk chunks per weight slot.
struct Tile {
  int cp;       // C rounded up to 16: the GEMM's K (and A's columns)
  int wn;       // output channels per warp and pass (NT * 8)
  int warps_n;  // warps across output channels
  int mr;       // rows of a chunk: (WARPS / warps_n) * 16 * TF32_MT
  int bn;       // output channels per pass: warps_n * wn
  int np;       // weight rows (output channels) padded to whole passes
  int kc;       // input channels per weight chunk (a chunk sum)
  int gk;       // weight chunks per slot
  int lda;      // A row stride in floats (cp + 4)
  int ldb;      // slot row stride in floats (gk * kc + 4)
};

__host__ __device__ inline Tile make_tile(int C, int gk = 1) {
  Tile g;
  g.cp = (C + 15) / 16 * 16;
  g.wn = g.cp < 64 ? g.cp : (g.cp >= 256 ? 32 : 64);
  const int nw = g.cp / g.wn;
  g.warps_n = nw >= 4 ? 4 : (nw >= 2 ? 2 : 1);
  g.mr = (WARPS / g.warps_n) * 16 * TF32_MT;
  g.bn = g.warps_n * g.wn;
  g.np = (g.cp + g.bn - 1) / g.bn * g.bn;
  g.kc = g.cp == 64 ? 64 : (g.cp % 32 == 0 ? 32 : 16);
  g.gk = gk;
  g.lda = g.cp + 4;
  g.ldb = gk * g.kc + 4;
  return g;
}

// NT = CP / 8 below CP = 64, 8 up to 255, 4 from 256 on; KC = Tile::kc.
template <int NT, int KC>
struct Tf32Path {
  static constexpr int MT = TF32_MT;
  static constexpr int MIN_BLOCKS = 1;
  static constexpr bool ASYNC = false;  // mma.sync: the warps run the mix

  // -- host: the plan's sizes --
  static int rows(int C) { return make_tile(C).mr; }
  static int passes(int C) {
    const Tile g = make_tile(C);
    return g.np / g.bn;
  }
  static int chunks(int C) { return make_tile(C).cp / KC; }  // per tap
  static size_t a_bytes(int C, int na) {
    return sizeof(float) * (size_t)na * make_tile(C).lda;
  }
  static size_t slot_bytes(int C, int gk) {
    const Tile g = make_tile(C, gk);
    return sizeof(float) * (size_t)g.bn * g.ldb;
  }

  // A's K padding, channels C .. CP - 1, stays zero: AA never writes it.
  static __device__ void zero_pad(void* A_, int na, int C, int) {
    float* A = static_cast<float*>(A_);
    const Tile g = make_tile(C);
    const int pad = g.cp - C;
    for (int i = threadIdx.x; i < na * pad; i += THREADS)
      A[(i / pad) * g.lda + C + i % pad] = 0.f;
  }

  // Weight stage s of pass p (tap j = s / ngc, chunks gk * (s % ngc) ..
  // + gk - 1), if it exists, into slot s % nslot: W[j][p*bn + n][c0 + i]
  // -> Bs[n][i] for n < bn, i < gk * KC. Always commits one cp.async
  // group.
  static __device__ __forceinline__ void load(const float* __restrict__ w,
                                              float* Bs, const Tile& g, int k,
                                              int p, int s, int nslot) {
    const int ngc = g.cp / (KC * g.gk);
    if (s < k * ngc) {
      const int j = s / ngc;
      const int c0 = (s % ngc) * g.gk * KC;
      const int per_row = g.gk * KC / 4;  // 16-byte pieces
      const float* src =
          w + ((size_t)j * g.np + (size_t)p * g.bn) * g.cp + c0;
      float* dst = Bs + (s % nslot) * g.bn * g.ldb;
      for (int i = threadIdx.x; i < g.bn * per_row; i += THREADS) {
        const int n = i / per_row;
        const int e = i % per_row;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_addr(dst + n * g.ldb + e * 4)),
                     "l"(src + (size_t)n * g.cp + e * 4));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // acc[row][co] = sum_j sum_ci A[row + j*d][ci] * W[j][pass*bn + co][ci]
  // for this warp's fragment (amp_layer_tc.cu's phase 2), chunk after
  // chunk of KC input channels in K2's order. With `resident`, every
  // weight stage has its own slot (the caller has issued the loads); else
  // the caller has issued stages 0 .. NSTAGE - 2 of this pass, and they
  // stream through NSTAGE slots. The first barrier also publishes A. Warps
  // whose rows all lie at or beyond nrow skip the MMAs.
  static __device__ void mix(const float* A, float* Bs,
                             const float* __restrict__ w, const Tile& g,
                             int k, int d, int pass, int nrow, bool resident,
                             float (&acc)[MT][NT][4]) {
    constexpr int ES = sizeof(float);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = (warp / g.warps_n) * 16 * MT;
    const int col0 = (warp % g.warps_n) * NT * 8;
    const bool active = row0 < nrow;
    // ldmatrix row addresses: A rows (lane & 15), 16-byte half (lane >> 4)
    // of each 32 bytes of K; B output channels (lane & 7) + 8 * (lane >>
    // 4), 16-byte half (lane >> 3) & 1
    const uint32_t a_base =
        smem_addr(A + (row0 + (lane & 15)) * g.lda) + (lane >> 4) * 16;
    const uint32_t b_base =
        smem_addr(Bs + (col0 + (lane & 7) + ((lane >> 4) << 3)) * g.ldb) +
        ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    const int ngc = g.cp / (KC * g.gk);
    const int nslot = resident ? k * ngc : NSTAGE;
    if (resident) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();  // A and the weights visible to all
    }
    int s = 0;
    for (int j = 0; j < k; ++j) {
      for (int cg = 0; cg < ngc; ++cg, ++s) {
        if (!resident) {
          // stage s has landed once at most NSTAGE - 2 newer groups pend
          asm volatile("cp.async.wait_group %0;\n" ::"n"(NSTAGE - 2));
          // stage s (and, at s = 0, A) visible to all; every warp is done
          // with stage s - 1, whose slot the next load refills
          __syncthreads();
          load(w, Bs, g, k, pass, s + NSTAGE - 1, NSTAGE);
        }
        if (!active) continue;
        for (int q = 0; q < g.gk; ++q) {
          const int c = cg * g.gk + q;
          const uint32_t b_stage =
              b_base + ES * ((s % nslot) * g.bn * g.ldb + q * KC);
          const uint32_t a_tap = a_base + ES * (j * d * g.lda + c * KC);
          // each chunk's products are summed in `part`, which is added to
          // acc in float32 with round to nearest
          float part[MT][NT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[m][n][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < KC * ES / 32; ++ks) {  // 32 bytes of K each
            uint32_t af[MT][4], af_small[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              ldmatrix_x4(af[m], a_tap + ES * m * 16 * g.lda + 32 * ks);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(af[m][e], af_small[m][e]);
            }
#pragma unroll
            for (int n = 0; n < NT / 2; ++n) {
              uint32_t bf[4], bs[4];
              ldmatrix_x4(bf, b_stage + ES * n * 16 * g.ldb + 32 * ks);
#pragma unroll
              for (int e = 0; e < 4; ++e) split_tf32(bf[e], bs[e]);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                mma_tf32x3(part[m][2 * n], af[m], af_small[m], bf[0], bf[1],
                           bs[0], bs[1]);
                mma_tf32x3(part[m][2 * n + 1], af[m], af_small[m], bf[2],
                           bf[3], bs[2], bs[3]);
              }
            }
          }
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int n = 0; n < NT; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][n][e] += part[m][n][e];
        }
      }
    }
  }

  // The epilogue of a pass. Fragment element (m, n, e) is row (lane >> 2)
  // + 8 * (e >> 1), column 2 * (lane & 3) + (e & 1) of its 16 x 8 tile.
  static __device__ void store(const float (&acc)[MT][NT][4], const Tile& g,
                               int pass, int C, int nrow,
                               const float* __restrict__ bias,
                               const float* res, int res_ld, float* out,
                               int ld) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row0 = (warp / g.warps_n) * 16 * MT;
    const int col0 = (warp % g.warps_n) * NT * 8;
    if (row0 >= nrow) return;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int co = pass * g.bn + col0 + n * 8 + 2 * (lane & 3);
      if (co >= C) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + m * 16 + (lane >> 2) + 8 * h;
          if (row < nrow)
            store_pair(acc[m][n][2 * h], acc[m][n][2 * h + 1], row, co, C,
                       bias, res, res_ld, out, ld);
        }
    }
  }

  // One stage (see amp_block_kernel).
  static __device__ void stage(const StageArgs& a, const Plan& pl, int T,
                               int C, int k, int rank, void* A_, void* W_,
                               uint64_t*, int&, int&) {
    float* A = static_cast<float*>(A_);
    float* Bs = static_cast<float*>(W_);
    const float* w = static_cast<const float*>(a.w);
    const Tile g = make_tile(C, pl.gk);
    const int hc = (k - 1) / 2 * a.d;
    const int lo = max(a.lo, -a.base);
    const int hi = min(a.hi, T - a.base);
    const int passes = g.np / g.bn;  // 1 where resident
    const int n_stages = k * (g.cp / (KC * g.gk));
    for (int r0 = lo; r0 < hi; r0 += g.mr) {
      const int nrow = min(g.mr, hi - r0);
      const int na = nrow + 2 * hc;
      // the weights in flight during AA: all of them once per stage where
      // they stay resident, else the ring's first stages
      if (!pl.resident) {
#pragma unroll
        for (int s = 0; s < NSTAGE - 1; ++s)
          load(w, Bs, g, k, rank, s, NSTAGE);
      } else if (r0 == lo) {
        for (int s = 0; s < n_stages; ++s) load(w, Bs, g, k, 0, s, n_stages);
      }
      aa_fill<float>(a, pl.ldx, T, C, a.base + r0 - hc, na, g.lda,
                     [&](int l, int c) { return A + l * g.lda + c; });
      for (int pass = rank; pass < passes; pass += pl.split) {
        if (pass > rank) {
          __syncthreads();  // every warp is done with the last pass's slots
#pragma unroll
          for (int s = 0; s < NSTAGE - 1; ++s)
            load(w, Bs, g, k, pass, s, NSTAGE);
        }
        float acc[MT][NT][4];
        mix(A, Bs, w, g, k, a.d, pass, nrow, pl.resident, acc);
        store(acc, g, pass, C, nrow, a.bias,
              a.res == nullptr ? nullptr : a.res + r0 * pl.ldx, pl.ldx,
              a.dst + (long long)r0 * a.dst_ld, a.dst_ld);
      }
      // A and the ring are refilled by the next chunk, the resident weights
      // by the next stage; dst is read by the next stage
      __syncthreads();
    }
  }
};

// -- the bf16 path: amp_layer_wgmma.cu's mix on wgmma ----------------------

// N output channels per pass, KS k16 steps per weight chunk (N, CP and KS
// as ops/kernels/amp.py::_wgmma_shape takes them; the weights in
// wgmma_weight's layout: chunk after chunk of KS x [N/8][2][8][8], by pass,
// then tap, then input channel), MT m64 tiles per warpgroup. A is stored
// as [channel group of 8][row][8 channels], rows padded to an odd count:
// a core matrix is 8 rows of one channel group, 128 contiguous bytes, so a
// descriptor can start at any row. With two A buffers (pl.abufs, where a
// stage's weights are resident), the warps compute the next chunk's AA
// while the tensor cores run the current chunk's wgmmas.
template <int N, int KS, int MT>
struct Bf16Path {
  static constexpr int MR = 2 * 64 * MT;  // two warpgroups
  static constexpr uint32_t CHUNK = 16 * KS * N * 2;  // bytes
  // blocks per SM the launch bounds ask for: one at N = 128 (C > 64),
  // measured faster there than two (tools/k3_variants.py, bounds_2), two
  // below
  static constexpr int MIN_BLOCKS = N >= 128 ? 1 : 2;
  static constexpr bool ASYNC = true;  // the mix runs beside the warps

  // -- host: the plan's sizes --
  __host__ __device__ static int cp(int C) {
    return C <= 32 ? (C + 15) / 16 * 16 : (C + 63) / 64 * 64;
  }
  static int rows(int) { return MR; }
  static int passes(int C) { return (C + N - 1) / N; }
  static int chunks(int C) { return cp(C) / (16 * KS); }  // per tap
  static size_t a_bytes(int C, int na) {
    return sizeof(bf16) * (size_t)(na | 1) * cp(C);
  }
  static size_t slot_bytes(int, int gk) { return (size_t)gk * CHUNK; }

  // The K padding, channels C .. CP - 1, of every A buffer stays zero: AA
  // never writes it.
  static __device__ void zero_pad(void* A_, int na, int C, int abufs) {
    bf16* A = static_cast<bf16*>(A_);
    const int pad = cp(C) - C, nap = na | 1;
    for (int i = threadIdx.x; i < abufs * nap * pad; i += THREADS) {
      const int c = C + i % pad;
      const int row = i / pad;  // over all buffers' rows
      A[(size_t)(row / nap) * nap * cp(C) +
        ((size_t)(c >> 3) * nap + row % nap) * 8 + (c & 7)] =
          __float2bfloat16_rn(0.f);
    }
  }

  // AA of the chunk at rows r0 .. r0 + nrow - 1 into A, then the fence
  // that lets the wgmmas (the async proxy) read it.
  static __device__ void fill_a(const StageArgs& a, const Plan& pl, int T,
                                int C, int k, bf16* A, int r0, int nrow) {
    const int nap = pl.na | 1;
    const int hc = (k - 1) / 2 * a.d;
    aa_fill<bf16>(a, pl.ldx, T, C, a.base + r0 - hc, nrow + 2 * hc, 8,
                  [&](int l, int c) {
                    return A + ((size_t)(c >> 3) * nap + l) * 8 + (c & 7);
                  });
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // This warpgroup's wgmmas of weight stage s (gk chunks of tap s / ngc)
  // at the slot `slot_addr`, over the m64 tiles of A at a_tile.
  static __device__ __forceinline__ void issue(float (&acc)[MT][N / 2],
                                               uint32_t a_tile,
                                               uint32_t a_lbo, int nap,
                                               uint32_t slot_addr, int s,
                                               int ngc, int gk, int d) {
    const int j = s / ngc;
    for (int q = 0; q < gk; ++q) {
      const int c = (s % ngc) * gk + q;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint64_t bd =
            ptts::desc(slot_addr + q * CHUNK + ks * N * 32, 128, 256);
        // A row r, channels 16 (c KS + ks) .. + 15: core matrices at
        // channel groups 2 (c KS + ks) and + 1
        const uint32_t a_k = a_tile + (2 * (c * KS + ks) * nap + j * d) * 16;
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ptts::wgmma_ss<N>(acc[m], ptts::desc(a_k + m * 64 * 16, a_lbo, 128),
                            bd);
      }
    }
  }

  // The epilogue of pass `pass` for the chunk at row r0: accumulator
  // element e of an m64 tile is row (lane >> 2) + 8 * ((e >> 1) & 1) of
  // this warp's 16, column 8 * (e >> 2) + 2 * (lane & 3) + (e & 1).
  static __device__ void store(const float (&acc)[MT][N / 2],
                               const StageArgs& a, const Plan& pl, int C,
                               int pass, int r0, int nrow) {
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wg = warp / 4, wl = warp % 4;
    const float* res = a.res == nullptr ? nullptr : a.res + r0 * pl.ldx;
    float* out = a.dst + (long long)r0 * a.dst_ld;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int co = pass * N + 8 * i + 2 * (lane & 3);
      if (co >= C) continue;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (wg * MT + m) * 64 + wl * 16 + (lane >> 2) + 8 * h;
          if (row < nrow)
            store_pair(acc[m][4 * i + 2 * h], acc[m][4 * i + 2 * h + 1], row,
                       co, C, a.bias, res, pl.ldx, out, a.dst_ld);
        }
    }
  }

  static __device__ __forceinline__ void zero(float (&acc)[MT][N / 2]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
      ptts::fence_regs(acc[m]);
    }
  }

  // One stage (see amp_block_kernel). The weight slots fill by one bulk
  // copy each, issued by thread 0, completing on the slot's mbarrier
  // (bars[0 .. NSTAGE - 1] for the ring, bars[NSTAGE] for resident
  // weights); every thread counts the block's fills in `fills` (ring) and
  // `rfills` (resident) in the same order, and a wait's parity is the
  // count's.
  static __device__ void stage(const StageArgs& a, const Plan& pl, int T,
                               int C, int k, int rank, void* A_, void* W_,
                               uint64_t* bars, int& fills, int& rfills) {
    bf16* A = static_cast<bf16*>(A_);
    unsigned char* W = static_cast<unsigned char*>(W_);
    const unsigned char* w = static_cast<const unsigned char*>(a.w);
    const int wg = threadIdx.x / 128;  // this warpgroup's rows: wg*64*MT ..
    const int nkc = cp(C) / (16 * KS), passes = (C + N - 1) / N;
    const int gk = pl.gk, ngc = nkc / gk, n_stages = k * ngc;
    const int nap = pl.na | 1;
    const size_t a_elems = (size_t)nap * cp(C);  // one A buffer
    const int lo = max(a.lo, -a.base);
    const int hi = min(a.hi, T - a.base);
    const uint32_t w_addr = smem_addr(W);
    const uint32_t a_lbo = nap * 16;  // between channel groups of 8
    auto a_tile = [&](const bf16* Ab) {
      return smem_addr(Ab) + wg * MT * 64 * 16;
    };
    // weight stage s of pass p: gk chunks of tap s / ngc
    auto src = [&](int p, int s) {
      return w + ((size_t)(p * k + s / ngc) * nkc + (s % ngc) * gk) * CHUNK;
    };
    auto fill_ring = [&](int p, int s) {  // stage s into the next ring slot
      if (s >= n_stages) return;
      if (threadIdx.x == 0) {
        const int slot = fills % NSTAGE;
        ptts::mbar_arrive_expect_tx(bars + slot, gk * CHUNK);
        ptts::bulk_load(W + (size_t)slot * gk * CHUNK, src(p, s),
                        gk * CHUNK, bars + slot);
      }
      ++fills;
    };
    auto fill_resident = [&]() {  // the pass's weights, once per stage
      if (threadIdx.x == 0) {
        ptts::mbar_arrive_expect_tx(bars + NSTAGE, n_stages * gk * CHUNK);
        ptts::bulk_load(W, src(0, 0), n_stages * gk * CHUNK, bars + NSTAGE);
      }
      ++rfills;
    };
    if (lo >= hi) return;
    float acc[MT][N / 2];
    if (pl.abufs == 2) {
      // resident weights, one pass: chunk i's wgmmas run while the warps
      // compute chunk i + 1's AA into the other A buffer
      fill_resident();
      fill_a(a, pl, T, C, k, A, lo, min(MR, hi - lo));
      __syncthreads();
      ptts::mbar_wait(bars + NSTAGE, (rfills - 1) & 1);
      for (int r0 = lo, i = 0; r0 < hi; r0 += MR, ++i) {
        const int nrow = min(MR, hi - r0);
        const bool active = wg * 64 * MT < nrow;
        bf16* Ab = A + (i & 1) * a_elems;
        zero(acc);
        if (active) {
          ptts::wgmma_fence();
          for (int s = 0; s < n_stages; ++s)
            issue(acc, a_tile(Ab), a_lbo, nap, w_addr + s * gk * CHUNK, s,
                  ngc, gk, a.d);
          ptts::wgmma_commit();
        }
        if (r0 + MR < hi)
          fill_a(a, pl, T, C, k, A + ((i + 1) & 1) * a_elems, r0 + MR,
                 min(MR, hi - r0 - MR));
        if (active) {
          ptts::wgmma_wait<0>();
#pragma unroll
          for (int m = 0; m < MT; ++m) ptts::fence_regs(acc[m]);
          store(acc, a, pl, C, 0, r0, nrow);
        }
        // the next chunk's A is whole; this chunk's is free for the one
        // after; dst is read by the next stage
        __syncthreads();
      }
      return;
    }
    for (int r0 = lo; r0 < hi; r0 += MR) {
      const int nrow = min(MR, hi - r0);
      const bool active = wg * 64 * MT < nrow;
      // the weights in flight during AA: all of them once per stage where
      // they stay resident, else the ring's first stages
      int first = fills;  // the fill count of the pass's stage 0
      int next = 0;       // the next weight stage to fill
      if (!pl.resident) {
        for (; next < NSTAGE - 1; ++next) fill_ring(rank, next);
      } else if (r0 == lo) {
        fill_resident();
      }
      fill_a(a, pl, T, C, k, A, r0, nrow);
      __syncthreads();
      for (int pass = rank; pass < passes; pass += pl.split) {
        if (pass > rank) {
          first = fills;
          for (next = 0; next < NSTAGE - 1; ++next) fill_ring(pass, next);
        }
        zero(acc);
        if (pl.resident) ptts::mbar_wait(bars + NSTAGE, (rfills - 1) & 1);
        for (int s = 0; s < n_stages; ++s) {
          uint32_t slot_addr = w_addr;
          if (!pl.resident) {
            const int f = first + s;
            ptts::mbar_wait(bars + f % NSTAGE, (f / NSTAGE) & 1);
            // stage s - 1's wgmmas are done with the slot the next fill
            // takes
            if (active) ptts::wgmma_wait<0>();
            __syncthreads();
            fill_ring(pass, next++);
            slot_addr += (f % NSTAGE) * gk * CHUNK;
          } else {
            slot_addr += s * gk * CHUNK;
          }
          if (!active) continue;
          ptts::wgmma_fence();
          issue(acc, a_tile(A), a_lbo, nap, slot_addr, s, ngc, gk, a.d);
          ptts::wgmma_commit();
        }
        if (active) {
          ptts::wgmma_wait<0>();
#pragma unroll
          for (int m = 0; m < MT; ++m) ptts::fence_regs(acc[m]);
          store(acc, a, pl, C, pass, r0, nrow);
        }
        // the wgmmas are done with A and the slots before the next pass or
        // chunk refills them; dst is read by the next stage
        __syncthreads();
      }
    }
  }
};

// -- the kernel --------------------------------------------------------------

// One block walks tiles; per tile it loads X, then runs each layer's two
// stages. A stage computes dst[r] = conv_d(AA_alpha(src))[r] + bias
// (+ res[r]) for the buffer rows r in [lo, hi) whose sample base + r lies
// in [0, T); src and res: buffer row 0 (sample base), rows ldx floats
// apart; dst: the destination's row 0, rows dst_ld floats apart. src holds
// K2's values at the samples [max(0, base + lo - hc - 6), t_hi), every
// sample that an output in [lo, hi) reads. Block `rank` of the `split`
// that share a tile computes AA over all channels and the output passes
// rank, rank + split, ...; with split > 1 a cluster barrier ends every
// stage, after which dst is whole for all of them.
template <class Path>
__global__ void __launch_bounds__(THREADS, Path::MIN_BLOCKS)
    amp_block_kernel(const float* __restrict__ x, float* __restrict__ y,
                     float* scratch, const __grid_constant__ Chain chain,
                     const __grid_constant__ Plan pl, int T, int C, int k) {
  extern __shared__ __align__(128) unsigned char smem[];
  void* W = smem;  // weight slots
  void* A = smem + pl.a_off;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + pl.bar_off);
  // the split blocks of a cluster share a tile and its slot of the scratch
  const int rank = pl.split > 1 ? cluster_rank() : 0;
  const int group = blockIdx.x / pl.split;
  const int groups = gridDim.x / pl.split;
  float* X = pl.global ? scratch + (size_t)group * 2 * pl.n * pl.ldx
                       : reinterpret_cast<float*>(smem + pl.x_off);
  float* H = X + (size_t)pl.n * pl.ldx;  // X, H: [n][ldx]
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i <= NSTAGE; ++i) ptts::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  Path::zero_pad(A, pl.na, C, pl.abufs);
  int fills = 0, rfills = 0;
  for (int tile = group; tile < pl.n_tiles; tile += groups) {
    const size_t batch = (size_t)(tile / pl.tiles_t) * T * C;
    const int base = (tile % pl.tiles_t) * pl.tt - pl.halo;  // row 0's sample
    // X rows whose samples lie in [0, T); the others are never read
    const int r_lo = max(0, -base);
    const int r_hi = min(pl.n, T - base);
    for (int e = tid + rank * THREADS; e < (r_hi - r_lo) * C;
         e += THREADS * pl.split) {
      const int r = r_lo + e / C;
      const int c = e % C;
      X[r * pl.ldx + c] = x[batch + (size_t)(base + r) * C + c];
    }
    if (pl.split > 1)
      cluster_sync();
    else
      __syncthreads();
    int lo = 0, hi = pl.n;  // the valid rows of the last stage's output
    for (int l = 0; l < chain.n_layers; ++l) {
      const Layer& L = chain.layer[l];
      for (int second = 0; second < 2; ++second) {
        StageArgs a;
        a.d = second ? 1 : L.d;
        a.t_hi = min(T, base + hi);
        const int reach = AA_REACH + (k - 1) / 2 * a.d;
        lo += reach;
        hi -= reach;
        a.lo = lo;
        a.hi = hi;
        a.base = base;
        const bool last = second && l == chain.n_layers - 1;
        a.src = second ? H : X;
        // the last stage writes the tile's own rows, [halo, halo + tt),
        // to y
        a.dst = !second ? H : (last ? y + batch + (long long)base * C : X);
        a.dst_ld = last ? C : pl.ldx;
        a.res = second ? X : nullptr;
        a.alpha = second ? L.a2 : L.a1;
        a.w = second ? L.w2 : L.w1;
        a.bias = second ? L.b2 : L.b1;
        Path::stage(a, pl, T, C, k, rank, A, W, bars, fills, rfills);
        if (pl.split > 1) cluster_sync();
      }
    }
  }
}

// -- the host ----------------------------------------------------------------

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

bool valid(int B, int T, int C, int k, const int* dils, int n_layers) {
  if (B <= 0 || T <= 0 || C <= 0 || k <= 0 || k % 2 == 0 || n_layers < 1 ||
      n_layers > MAX_LAYERS)
    return false;
  for (int l = 0; l < n_layers; ++l)
    if (dils[l] < 1) return false;
  return true;
}

// The plan of one launch of kernel `fn` of path P, its shared memory, grid
// and global scratch (floats). X and H go to the global scratch with tiles
// of up to GLOBAL_TT, or, for the synchronous (float32) path where a tile
// of SMEM_TT fits, to shared memory with the largest tile that does; the
// tiles are cut to fill whole waves of the blocks the SMs hold, down to
// MIN_TT. A stage's weights stay resident (loaded once per stage)
// where the pass is one and they fit in half a block's shared memory beside
// A, one slot per tap; else the slots of the weight ring take the most
// chunks that fit in half a block's shared memory (all of it where one slot
// does not). Where there are several output passes and fewer tiles than the
// SMs hold, two blocks, a cluster, share each tile. An asynchronous mix
// (bf16) with resident weights takes a second A buffer where both fit in
// half a block's shared memory. hints (may be null): {tt, mode, resident,
// split, gk, abufs} override the choices where > 0 for tt, split, gk and
// abufs, >= 0 for mode (0: X and H in shared memory, 1: the scratch) and
// resident, for the timing tool promptttspp_tpu_torch/tools/k3_variants.py.
template <class P>
cudaError_t make_plan(const void* fn, int B, int T, int C, int k,
                      const int* dils, int n_layers, const int* hints,
                      Plan* pl, size_t* smem, int* grid,
                      long long* scratch_floats) {
  const int tt = hints ? hints[0] : 0, mode = hints ? hints[1] : -1;
  const int resident = hints ? hints[2] : -1, split = hints ? hints[3] : 0;
  const int gk = hints ? hints[4] : 0, abufs = hints ? hints[5] : 0;
  int hc_max = 0;
  pl->halo = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int hc = (k - 1) / 2 * dils[l];
    pl->halo += 2 * AA_REACH + hc + (k - 1) / 2;
    hc_max = hc > hc_max ? hc : hc_max;
  }
  pl->na = P::rows(C) + 2 * hc_max;
  pl->ldx = (C + 1) / 2 * 2 + 8;  // float2 stores; rows 8 banks apart
  const size_t a_bytes = P::a_bytes(C, pl->na);
  const int nkc = P::chunks(C), passes = P::passes(C);
  pl->resident =
      resident >= 0
          ? resident
          : passes == 1 && a_bytes + k * P::slot_bytes(C, nkc) <= SMEM_MAX / 2;
  if (pl->resident && passes != 1) return cudaErrorInvalidValue;
  if (pl->resident) {
    pl->gk = nkc;
  } else if (gk > 0) {
    pl->gk = gk;
  } else {
    const size_t budget =
        a_bytes + NSTAGE * P::slot_bytes(C, 1) > SMEM_MAX / 2 ? SMEM_MAX
                                                               : SMEM_MAX / 2;
    pl->gk = 1;
    for (int n = 2; n <= nkc; ++n)
      if (nkc % n == 0 && a_bytes + NSTAGE * P::slot_bytes(C, n) <= budget)
        pl->gk = n;
  }
  if (pl->gk < 1 || nkc % pl->gk != 0) return cudaErrorInvalidValue;
  const size_t w_bytes =
      (size_t)(pl->resident ? k : NSTAGE) * P::slot_bytes(C, pl->gk);
  pl->abufs = abufs > 0 ? abufs
                        : (P::ASYNC && pl->resident &&
                                   2 * a_bytes + w_bytes <= SMEM_MAX / 2
                               ? 2
                               : 1);
  if (pl->abufs > 2 || (pl->abufs == 2 && !(P::ASYNC && pl->resident)))
    return cudaErrorInvalidValue;
  const size_t bars = 8 * (NSTAGE + 1);
  pl->a_off = (int)((w_bytes + 127) / 128 * 128);
  pl->bar_off = (int)((pl->a_off + pl->abufs * a_bytes + 15) / 16 * 16);
  pl->x_off = (int)(pl->bar_off + (bars + 15) / 16 * 16);
  const size_t fixed = pl->x_off;
  if (fixed > SMEM_MAX) return cudaErrorInvalidValue;
  const size_t row_bytes = 2 * sizeof(float) * pl->ldx;  // a row of X and H
  const long long tt_smem =
      (long long)((SMEM_MAX - fixed) / row_bytes) - 2 * pl->halo;
  pl->global = mode >= 0 ? mode : P::ASYNC || tt_smem < SMEM_TT;
  long long tt_max = tt > 0 ? tt : (pl->global ? GLOBAL_TT : tt_smem);
  if (tt_max < 1 || (!pl->global && tt_max > tt_smem))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // blocks per SM at the largest tile
  *smem = fixed + (pl->global ? 0 : (size_t)(tt_max + 2 * pl->halo) *
                                        row_bytes);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_MAX);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      *smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)sms * (per_sm > 0 ? per_sm : 1);
  int tiles_t = (int)ceil_div(T, tt_max);
  pl->split = split > 0 ? split
                        : (passes > 1 && pl->global &&
                                   (long long)B * tiles_t < blocks
                               ? 2
                               : 1);
  if (pl->split > 2 || pl->split > passes || (pl->split > 1 && !pl->global))
    return cudaErrorInvalidValue;
  const long long slots = blocks / pl->split;  // tiles in flight
  if (tt <= 0) {
    const long long fill = ceil_div((long long)B * tiles_t, slots) * slots / B;
    const long long most = T / MIN_TT > 1 ? T / MIN_TT : 1;
    const long long more = fill < most ? fill : most;
    if (more > tiles_t) tiles_t = (int)more;
  }
  pl->tt = (int)ceil_div(T, tiles_t);
  pl->tiles_t = (int)ceil_div(T, pl->tt);
  pl->n_tiles = B * pl->tiles_t;
  pl->n = pl->tt + 2 * pl->halo;
  *smem = fixed + (pl->global ? 0 : (size_t)pl->n * row_bytes);
  const long long groups = pl->n_tiles < slots ? pl->n_tiles : slots;
  *grid = (int)(groups * pl->split);
  *scratch_floats = pl->global ? groups * 2 * pl->n * pl->ldx : 0;
  return cudaSuccess;
}

// With chain == nullptr, *need = the launch's scratch floats; else the
// launch, given `scratch_floats` floats of scratch.
template <class P>
int run(const float* x, float* y, float* scratch, long long scratch_floats,
        const Chain* chain, const int* dils, int n_layers, int B, int T,
        int C, int k, const int* hints, long long* need,
        cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(amp_block_kernel<P>);
  Plan pl;
  size_t smem;
  int grid;
  cudaError_t err = make_plan<P>(fn, B, T, C, k, dils, n_layers, hints, &pl,
                                 &smem, &grid, need);
  if (err != cudaSuccess) return (int)err;
  if (chain == nullptr) return 0;
  if (scratch_floats < *need || (*need > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = pl.split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, amp_block_kernel<P>, x, y, scratch, *chain,
                           pl, T, C, k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The compiled paths: bf16 by N (the smallest of 16, 32, 64, 128 that
// covers C, else 128 in passes) with its KS, two m64 tiles per warpgroup
// up to N = 64; float32 by Tile's NT and KC.
int dispatch(int bf16_mix, const float* x, float* y, float* scratch,
             long long scratch_floats, const Chain* chain, const int* dils,
             int n_layers, int B, int T, int C, int k, const int* hints,
             long long* need, cudaStream_t stream) {
#define AMP_BLOCK_ARGS                                                      \
  x, y, scratch, scratch_floats, chain, dils, n_layers, B, T, C, k, hints, \
      need, stream
  if (bf16_mix) {
    if (C <= 16) return run<Bf16Path<16, 1, 2>>(AMP_BLOCK_ARGS);
    if (C <= 32) return run<Bf16Path<32, 2, 2>>(AMP_BLOCK_ARGS);
    if (C <= 64) return run<Bf16Path<64, 4, 2>>(AMP_BLOCK_ARGS);
    return run<Bf16Path<128, 4, 1>>(AMP_BLOCK_ARGS);
  }
  const Tile g = make_tile(C);
  const int nt = g.wn / 8;
#define AMP_BLOCK_TF32(NT_, KC_) \
  if (nt == NT_ && g.kc == KC_) return run<Tf32Path<NT_, KC_>>(AMP_BLOCK_ARGS);
  AMP_BLOCK_TF32(2, 16)
  AMP_BLOCK_TF32(4, 16)
  AMP_BLOCK_TF32(4, 32)
  AMP_BLOCK_TF32(6, 16)
  AMP_BLOCK_TF32(8, 16)
  AMP_BLOCK_TF32(8, 32)
  AMP_BLOCK_TF32(8, 64)
#undef AMP_BLOCK_TF32
#undef AMP_BLOCK_ARGS
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

// The most layers one launch takes; the caller splits longer chains into
// consecutive launches.
extern "C" int amp_block_max_layers() { return MAX_LAYERS; }

// The weight layout amp_block takes at C channels, into shape[0..1]: the
// rows and columns of the float32 path's [k, rows, cols]
// (ops/kernels/amp.py::tc_weight, the float32 K2's), or N and CP of the
// bf16 path's wgmma_weight (K2-bf16's).
extern "C" void amp_block_weight_shape(int C, int bf16_mix, int* shape) {
  if (bf16_mix) {
    shape[0] = C <= 16 ? 16 : (C <= 32 ? 32 : (C <= 64 ? 64 : 128));
    shape[1] = Bf16Path<16, 1, 2>::cp(C);
  } else {
    const Tile g = make_tile(C);
    shape[0] = g.np;
    shape[1] = g.cp;
  }
}

// Floats of global scratch amp_block needs for this shape (0 when X and H
// live in shared memory), or a negative CUDA error code. hints: null, or
// the plan's overrides (make_plan).
extern "C" long long amp_block_scratch_floats(int B, int T, int C, int k,
                                              const int* dils, int n_layers,
                                              int bf16_mix,
                                              const int* hints) {
  if (!valid(B, T, C, k, dils, n_layers))
    return -(long long)cudaErrorInvalidValue;
  long long need = 0;
  const int err = dispatch(bf16_mix, nullptr, nullptr, nullptr, 0, nullptr,
                           dils, n_layers, B, T, C, k, hints, &need, nullptr);
  return err == 0 ? need : -(long long)err;
}

// x, y: [B, T, C] float32; scratch: amp_block_scratch_floats() floats (may
// be null when that is 0); layer_ptrs: host array of 6 device pointers per
// layer, (alpha1, w1, b1, alpha2, w2, b2), w* in the layout
// amp_block_weight_shape names (ops/kernels/amp.py::kernel_weight_wgmma
// with bf16_mix, else kernel_weight_tf32x3); dils: host array of the
// layers' conv1 dilations; hints: as for amp_block_scratch_floats. Takes
// any C >= 1, odd k, 1 to amp_block_max_layers() layers with dilations
// >= 1; needs 16-byte aligned w*, b* and y. Returns the CUDA error code (0
// on success): cudaErrorInvalidValue also for a conv halo whose A operand
// does not fit in a block's shared memory.
extern "C" int amp_block(const float* x, float* y, float* scratch,
                         long long scratch_floats,
                         const void* const* layer_ptrs, const int* dils,
                         int n_layers, int B, int T, int C, int k,
                         int bf16_mix, const int* hints, void* stream) {
  if (!valid(B, T, C, k, dils, n_layers))
    return (int)cudaErrorInvalidValue;
  Chain chain;
  chain.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    const void* const* p = layer_ptrs + 6 * l;
    for (int i = 0; i < 6; ++i)
      if (p[i] == nullptr || ((i % 3 != 0) && !aligned16(p[i])))
        return (int)cudaErrorMisalignedAddress;
    chain.layer[l] = Layer{(const float*)p[0], p[1], (const float*)p[2],
                           (const float*)p[3], p[4], (const float*)p[5],
                           dils[l]};
  }
  if (!aligned16(y)) return (int)cudaErrorMisalignedAddress;
  long long need = 0;
  return dispatch(bf16_mix, x, y, scratch, scratch_floats, &chain, dils,
                  n_layers, B, T, C, k, hints, &need, (cudaStream_t)stream);
}
