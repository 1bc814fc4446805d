// Kernel K2-bf16 for Hopper: one launch of a BigVGAN AMPLayer's two,
//
//   aa_conv(x, alpha1, w1, b1, d, residual = none) -> h
//   aa_conv(h, alpha2, w2, b2, 1, residual = x)    -> y
//
// out[t][co] = bias[co] + sum_j sum_ci A[t + (j - (k-1)/2) d][ci] W[j][co][ci]
// (+ residual[t][co]), A = bf16(AA(x)), with the channel mix on wgmma.
//
// Replaces promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer (:332, via
// fused_amp_block :348 and its pallas_call :438) at mxu_bf16=True, the
// JAX AMPLayer's fused path at conv_precision="default"
// (vocoders/bigvgan.py:131-139). Its arithmetic is that of the mma.sync
// kernel amp_layer_tc.cu::Bf16Mix: AA in float32 from registers
// (ptts::aa_run; the length of a run does not change its values), rounded
// once to bf16 (round to nearest even) as the mix's A operand; bf16
// weights; float32 sums; the bias and the residual added in float32. AA
// clamps its input to [0, T), the conv reads zeros outside [0, T). For
// each output the sum runs over tap j, then input chunk, then k16 step,
// into one float32 accumulator, with no split-K and no atomics: the kernel
// is deterministic, and its order is the mma.sync kernel's (its output
// bits equal that kernel's: wgmma sums a k16 step as mma.sync does).
//
// Bound on an H100 SXM at 700 W, per 640-frame request (72 launches): the
// mix ~2.6e11 flops, 0.265 ms at 989 TFLOP/s of bf16; AA ~2.2e10 flops of
// float32, 0.333 ms at 67 TFLOP/s; x and y 0.292 ms at 3.35 TB/s. AA and
// the bytes bound it as much as the mix does, and they use other units:
// the design runs them side by side.
//
// Design (C++ for sm_90a, launched on the caller's stream, allocating
// nothing; everything that depends on the shape comes from the host plan,
// ops/kernels/amp.py::wgmma_plan):
// - A persistent grid, one block per SM, walks the items (batch row, time
//   tile of TT = 64 * MT * NWG samples, output pass of N channels).
// - Warp specialisation. NWG consumer warpgroups (warps 0 .. 4 NWG - 1) run
//   the mix of the current item; PW producer warps compute AA for the next
//   item into the other of two bf16 A buffers; the last warp loads the
//   weights. The roles hand the buffers over through mbarriers (a full and
//   an empty barrier per buffer), never through __syncthreads. The
//   producers walk the runs of all their items as one sequence, so an
//   item's work is spread over them to within one run.
// - The mix is an implicit GEMM on wgmma.mma_async m64nNk16, bf16 x bf16
//   -> f32, both operands read from shared memory through matrix
//   descriptors without swizzle: tap j's A operand is the tile's rows
//   shifted by j d. A is stored as [channel group of 8][row][8 channels]
//   (rows padded to an odd count, so that a warp's stores to four channel
//   groups fall in different banks): a core matrix is 8 consecutive rows
//   of one channel group, 128 contiguous bytes, so a descriptor can start
//   at any row. (With A from registers, the RS form, each chunk's wgmmas
//   had to complete before its fragment registers could be loaded again,
//   and the mix alone took longer than the mma.sync kernel's; the SS form
//   issues all of an item's wgmmas back to back and waits once.)
// - The weights arrive through the TMA unit: the host lays them out once
//   as the exact shared-memory image that the B descriptors read (core
//   matrices of 8 output channels x 8 input channels), chunk after chunk
//   in the order the kernel consumes them, so each chunk is one
//   cp.async.bulk copy into mbarrier-tracked shared memory, issued by one
//   thread (no tensor map). Where all k taps of a pass fit beside the A
//   buffers (every k at C <= 64, k = 3 at C = 128), a block loads them once
//   and keeps them; otherwise they stream through a ring of NSTAGE chunks
//   with full and empty barriers.
// - At C = 256 the plan takes two passes of 128 output channels, each
//   computing AA for its tile: 120 items of 64 samples fill the SMs where
//   one pass would leave 72 of 132 idle.
// - The epilogue writes each output from the accumulators with the bias
//   (and the residual) added, masked at the ragged end of T and for any
//   C >= 1.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "polyops.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The host plan, as the launcher receives it (ops/kernels/amp.py::
// WGMMA_PLAN_FIELDS, in this order).
enum PlanField {
  kN, kPasses, kCp, kKs, kNwg, kMt, kPw, kTt, kNa, kNap, kResident,
  kNstage, kAbufs, kSmem, kPlanLen
};

struct Params {
  const float* x;
  const float* alpha;
  const bf16* w;
  const float* bias;
  const float* residual;
  float* y;
  int T, C, k, d;
  int passes, cp, nkc;  // nkc: weight chunks (KS k16 steps each) per tap
  int hc, na, nap;  // nap: A rows as stored, na rounded up to odd
  int resident, nstage, abufs;
  int n_tiles, n_items;
  uint32_t w_bytes, a_bytes, chunk_bytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that has
// not returned after 2^35 clock cycles (about 17 s) traps: the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 35)) asm volatile("trap;\n");
  }
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most PENDING committed groups of this warpgroup's wgmmas
// are still running.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keep the compiler from moving accesses of an accumulator register across
// the asynchronous wgmma that owns it.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Matrix descriptor of a K-major tile without swizzle: core matrices of 8
// rows x 16 bytes (8 bf16 along K), 128 contiguous bytes each; `lbo` bytes
// between the two core matrices of a k16 step (K), `sbo` bytes between
// groups of 8 rows (M or N). The start address needs 16-byte alignment
// only, so an A tile may start at any row.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d[N/2] += A (m64 x k16 bf16 at a_desc) * B (k16 x N bf16 at b_desc);
// bf16 x bf16 -> f32, both K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a_desc,
                                         uint64_t b_desc);

template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128],
                                              uint64_t a_desc,
                                              uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a_desc), "l"(b_desc), "r"(1));
}

// A configuration: output channels per pass N, k16 steps per weight chunk
// KS, consumer warpgroups NWG, m64 tiles per consumer warpgroup MT, AA
// producer warps PW, AA samples per producer run R. A block is THREADS
// threads, one per SM. An SM's registers are four files of 512 per thread
// lane, one per scheduler, and warp w runs on scheduler w % 4, so a thread
// gets at most 512 / ceil(WARPS / 4) registers, rounded down to 8 (80 at
// 24 warps, 128 at 16). Every role
// is compiled within that count: ptxas (CUDA 12.9) compiles a kernel
// within its launch count even in a region after setmaxnreg.inc (it
// refuses an m64n256 wgmma there at 128 registers, C7602;
// tools/setmaxnreg_probe.py), so the consumers' N/2 * MT accumulator
// registers set how many warps a block can have, and AA, which bounds the
// kernel, wants as many producers as possible.
template <int N_, int KS_, int NWG_, int MT_, int PW_, int R_>
struct Cfg {
  static constexpr int N = N_, KS = KS_, NWG = NWG_, MT = MT_, PW = PW_;
  static constexpr int R = R_;
  static constexpr int WARPS = 4 * NWG + PW + 1;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int TT = 64 * MT * NWG;
  static_assert(N % 8 == 0 && N >= 16 && N <= 256, "wgmma N");
  static_assert(THREADS <= 1024, "block size");
};

// The weight loader (one thread): every bulk copy of the weights, all
// chunks at once into the resident copy, or chunk after chunk through the
// ring as the consumers free its stages.
__device__ __forceinline__ void load_weights(const Params& p, bf16* wsm,
                                             uint64_t* w_full,
                                             uint64_t* w_empty) {
  const int per_tile = p.passes;
  const int nch = p.k * p.nkc;  // chunks per pass
  if (p.resident) {
    mbar_arrive_expect_tx(w_full, p.chunk_bytes * nch);
    for (int q = 0; q < nch; ++q)
      bulk_load(reinterpret_cast<unsigned char*>(wsm) +
                    (size_t)q * p.chunk_bytes,
                reinterpret_cast<const unsigned char*>(p.w) +
                    (size_t)q * p.chunk_bytes,
                p.chunk_bytes, w_full);
    return;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x) {
    const int pass = item % per_tile;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(p.w) +
        (size_t)pass * nch * p.chunk_bytes;
    for (int q = 0; q < nch; ++q) {
      mbar_wait(w_empty + stage, phase ^ 1);
      mbar_arrive_expect_tx(w_full + stage, p.chunk_bytes);
      bulk_load(reinterpret_cast<unsigned char*>(wsm) +
                    (size_t)stage * p.chunk_bytes,
                src + (size_t)q * p.chunk_bytes, p.chunk_bytes,
                w_full + stage);
      if (++stage == p.nstage) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The AA producers (thread ptid of NPROD): run g of this block's sequence
// belongs to producer thread g % NPROD; an item's runs are (channel c, rows
// l0 .. l0 + R - 1) in the order c fastest, so a warp reads 32 neighbouring
// channels of x.
template <class G>
__device__ __forceinline__ void produce(const Params& p, bf16* abuf,
                                        uint64_t* a_full, uint64_t* a_empty,
                                        int ptid) {
  constexpr int TT = G::TT, R = G::R;
  constexpr int NPROD = 32 * G::PW;
  const int per_tile = p.passes;
  const int n_runs = p.C * ((p.na + R - 1) / R);  // per item
  int base = 0;  // (runs of the earlier items) % NPROD
  for (int item = blockIdx.x, it = 0; item < p.n_items;
       item += gridDim.x, ++it) {
    const int b = it % p.abufs;
    const uint32_t use = it / p.abufs;
    mbar_wait(a_empty + b, (use & 1) ^ 1);
    const int tile = (item / per_tile) % p.n_tiles;
    const int batch = item / (per_tile * p.n_tiles);
    const float* xb = p.x + (size_t)batch * p.T * p.C;
    bf16* A = abuf + (size_t)b * (p.a_bytes / sizeof(bf16));
    const int a0 = tile * TT - p.hc;  // sample of A row 0
    int first = ptid - base;
    if (first < 0) first += NPROD;
    for (int run = first; run < n_runs; run += NPROD) {
      const int c = run % p.C;
      const int l0 = (run / p.C) * R;
      const int p0 = a0 + l0;
      bf16* Ac = A + ((size_t)(c >> 3) * p.nap + l0) * 8 + (c & 7);
      if (p0 + R <= 0 || p0 >= p.T) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (l0 + r < p.na) Ac[r * 8] = __float2bfloat16_rn(0.f);
        continue;
      }
      const float a = expf(p.alpha[c]);
      const float inv_a = 1.f / (a + 1e-9f);
      float out[R];
      ptts::aa_run<R>(xb + c, p.C, p.T, p0, a, inv_a,
                      [&](int r, float v) { out[r] = v; });
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = p0 + r;
        if (l0 + r < p.na)
          Ac[r * 8] = __float2bfloat16_rn((s >= 0 && s < p.T) ? out[r] : 0.f);
      }
    }
    base = (base + n_runs) % NPROD;
    // the consumers' wgmmas read A through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(a_full + b);
  }
}

// The consumer warpgroups: the mix of each item on wgmma, then its
// epilogue. All of an item's wgmmas are issued back to back, each chunk's
// committed as a group; a streamed chunk's stage is handed back once the
// group after it has been committed and its own has completed.
template <class G>
__device__ __forceinline__ void consume(const Params& p, bf16* wsm,
                                        bf16* abuf, uint64_t* a_full,
                                        uint64_t* a_empty, uint64_t* w_full,
                                        uint64_t* w_empty, int warp,
                                        int lane) {
  constexpr int N = G::N, KS = G::KS, MT = G::MT, TT = G::TT;
  const int per_tile = p.passes;
  const int wg = warp / 4;
  const int wl = warp % 4;  // this warp's 16 rows of each m64 tile
  const uint32_t wsm_addr = smem_addr(wsm);
  const uint32_t a_lbo = p.nap * 16;  // between channel groups of 8
  if (p.resident) mbar_wait(w_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  float acc[MT][N / 2];
  for (int item = blockIdx.x, it = 0; item < p.n_items;
       item += gridDim.x, ++it) {
    const int b = it % p.abufs;
    const uint32_t use = it / p.abufs;
    const int pass = item % per_tile;
    const int tile = (item / per_tile) % p.n_tiles;
    const int batch = item / (per_tile * p.n_tiles);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[m][e] = 0.f;
      fence_regs(acc[m]);
    }
    mbar_wait(a_full + b, use & 1);
    // A row r, channels 16 q .. 16 q + 15: core matrices at channel groups
    // 2q and 2q + 1
    const uint32_t a_tile =
        smem_addr(abuf) + b * p.a_bytes + wg * MT * 64 * 16;
    wgmma_fence();
    int prev = -1;  // the streamed stage of the previous chunk
    for (int j = 0; j < p.k; ++j) {
      for (int c = 0; c < p.nkc; ++c) {
        uint32_t w_chunk;
        if (p.resident) {
          w_chunk = wsm_addr + (j * p.nkc + c) * p.chunk_bytes;
        } else {
          mbar_wait(w_full + stage, phase);
          w_chunk = wsm_addr + stage * p.chunk_bytes;
        }
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const uint64_t bd = desc(w_chunk + s * N * 32, 128, 256);
          const uint32_t a_k =
              a_tile + (2 * (c * KS + s) * p.nap + j * p.d) * 16;
#pragma unroll
          for (int m = 0; m < MT; ++m)
            wgmma_ss<N>(acc[m], desc(a_k + m * 64 * 16, a_lbo, 128), bd);
        }
        wgmma_commit();
        if (!p.resident) {
          // the chunk before this one is done: its stage may be refilled
          wgmma_wait<1>();
          if (prev >= 0) mbar_arrive(w_empty + prev);
          prev = stage;
          if (++stage == p.nstage) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) fence_regs(acc[m]);
    if (prev >= 0) mbar_arrive(w_empty + prev);
    mbar_arrive(a_empty + b);

    // epilogue: accumulator element e of an m64 tile is row (lane >> 2) +
    // 8 * ((e >> 1) & 1) of this warp's 16, column 8 * (e >> 2) + 2 *
    // (lane & 3) + (e & 1). co is even, so at an even C the pair (co, co +
    // 1) lies inside the row and is 8-byte aligned; at an odd C it is
    // written as scalars, the second only if co + 1 < C.
    const size_t row0 = (size_t)batch * p.T;
    const bool pair = (p.C & 1) == 0;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int co = pass * N + 8 * i + 2 * (lane & 3);
      if (co >= p.C) continue;
      const bool second = co + 1 < p.C;
      const float2 bv =
          pair ? *reinterpret_cast<const float2*>(p.bias + co)
               : make_float2(p.bias[co], second ? p.bias[co + 1] : 0.f);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = tile * TT + (wg * MT + m) * 64 + wl * 16 +
                        (lane >> 2) + 8 * h;
          if (t >= p.T) continue;
          const size_t off = (row0 + t) * p.C + co;
          float2 o = make_float2(acc[m][4 * i + 2 * h] + bv.x,
                                 acc[m][4 * i + 2 * h + 1] + bv.y);
          if (pair) {
            if (p.residual != nullptr) {
              const float2 rv =
                  *reinterpret_cast<const float2*>(p.residual + off);
              o.x += rv.x;
              o.y += rv.y;
            }
            *reinterpret_cast<float2*>(p.y + off) = o;
          } else {
            if (p.residual != nullptr) {
              o.x += p.residual[off];
              if (second) o.y += p.residual[off + 1];
            }
            p.y[off] = o.x;
            if (second) p.y[off + 1] = o.y;
          }
        }
      }
    }
  }
}

template <class G>
__global__ void __launch_bounds__(G::THREADS, 1)
    aa_conv_wgmma_kernel(const __grid_constant__ Params p) {
  constexpr int NCONS = 128 * G::NWG;  // consumer threads
  constexpr int NPROD = 32 * G::PW;    // producer threads
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wsm = reinterpret_cast<bf16*>(smem);  // weights: all or a ring
  bf16* abuf = reinterpret_cast<bf16*>(smem + p.w_bytes);  // abufs x A
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(smem + p.w_bytes + p.abufs * p.a_bytes);
  uint64_t* a_full = bars;           // [abufs], NPROD arrivals
  uint64_t* a_empty = bars + 2;      // [abufs], NCONS arrivals
  uint64_t* w_full = bars + 4;       // [nstage], 1 arrival + bytes
  uint64_t* w_empty = w_full + p.nstage;  // [nstage], NCONS arrivals
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int b = 0; b < p.abufs; ++b) {
      mbar_init(a_full + b, NPROD);
      mbar_init(a_empty + b, NCONS);
    }
    for (int s = 0; s < p.nstage; ++s) {
      mbar_init(w_full + s, 1);
      mbar_init(w_empty + s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // A's padding channels C .. CP - 1 stay zero: the producers never write
  // them
  if (p.cp > p.C) {
    const int pad = p.cp - p.C;
    for (int i = tid; i < p.abufs * p.nap * pad; i += G::THREADS) {
      const int c = p.C + i % pad;
      const int row = i / pad;  // over all buffers' rows
      const int b = row / p.nap;
      abuf[(size_t)b * (p.a_bytes / sizeof(bf16)) +
           ((size_t)(c >> 3) * p.nap + row % p.nap) * 8 + (c & 7)] =
          __float2bfloat16_rn(0.f);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it
  const int warp = __shfl_sync(0xffffffff, tid / 32, 0);
  const int lane = tid % 32;
  if (warp < 4 * G::NWG)
    consume<G>(p, wsm, abuf, a_full, a_empty, w_full, w_empty, warp, lane);
  else if (warp < G::WARPS - 1)
    produce<G>(p, abuf, a_full, a_empty, tid - NCONS);
  else if (lane == 0)
    load_weights(p, wsm, w_full, w_empty);
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0;
}

constexpr int kSmemPerBlock = 232448;  // an H100 block's shared memory

// The first launch of a configuration lifts its shared-memory cap to all a
// block may have, so that later launches, inside a CUDA-graph capture too,
// make no other runtime call than the launch.
template <class G>
int launch(const Params& p, int smem, int grid, cudaStream_t stream) {
  static bool capped = false;
  if (!capped) {
    const cudaError_t err = cudaFuncSetAttribute(
        aa_conv_wgmma_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemPerBlock);
    if (err != cudaSuccess) return (int)err;
    capped = true;
  }
  aa_conv_wgmma_kernel<G><<<grid, G::THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The compiled configurations (see Cfg; ops/kernels/amp.py::WGMMA_CONFIGS
// names the same ones, the plan's first for each N). The runs of 8 let 32
// warps fit at 64 registers; they measured slower than runs of 16 at 24.
#define AMP_WGMMA_CONFIGS(X) \
  X(16, 1, 1, 2, 8, 16)       \
  X(32, 2, 2, 2, 15, 16)      \
  X(32, 2, 1, 4, 11, 16)      \
  X(32, 2, 1, 2, 19, 16)      \
  X(32, 2, 2, 2, 23, 8)       \
  X(64, 4, 2, 1, 15, 16)      \
  X(64, 4, 2, 1, 19, 16)      \
  X(64, 4, 2, 1, 23, 8)       \
  X(128, 4, 1, 1, 15, 16)     \
  X(128, 4, 1, 1, 11, 16)     \
  X(256, 4, 1, 1, 7, 16)

}  // namespace

// x, residual (nullable), y: [B, T, C] float32; alpha, bias: [C] float32;
// w: bf16 in the layout of ops/kernels/amp.py::wgmma_weight for the plan's
// N and CP; plan: the kPlanLen ints of ops/kernels/amp.py::wgmma_plan;
// grid: the blocks (at most the items). Takes any C >= 1, odd k, d >= 1,
// B, T >= 1; needs 16-byte aligned w and bias, y and residual. Returns the
// CUDA error code (0 on success): cudaErrorInvalidValue for a plan that
// disagrees with the shape, cudaErrorInvalidConfiguration for one that
// names no compiled configuration.
extern "C" int amp_aa_conv_wgmma(const float* x, const float* alpha,
                                 const void* w, const float* bias,
                                 const float* residual, float* y, int B,
                                 int T, int C, int k, int d, const int* plan,
                                 int grid, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0 || k <= 0 || k % 2 == 0 || d <= 0 ||
      grid <= 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(w) || !aligned16(bias) || !aligned16(y) ||
      (residual != nullptr && !aligned16(residual)))
    return (int)cudaErrorMisalignedAddress;
  const int n = plan[kN], cp = plan[kCp], ks = plan[kKs];
  Params p;
  p.x = x;
  p.alpha = alpha;
  p.w = static_cast<const bf16*>(w);
  p.bias = bias;
  p.residual = residual;
  p.y = y;
  p.T = T;
  p.C = C;
  p.k = k;
  p.d = d;
  p.passes = plan[kPasses];
  p.cp = cp;
  p.nkc = cp / (16 * ks);
  p.hc = (k - 1) / 2 * d;
  p.na = plan[kNa];
  p.nap = plan[kNap];
  p.resident = plan[kResident];
  p.nstage = plan[kNstage];
  p.abufs = plan[kAbufs];
  const int tt = 64 * plan[kMt] * plan[kNwg];
  p.n_tiles = (T + tt - 1) / tt;
  p.n_items = B * p.n_tiles * p.passes;
  p.chunk_bytes = 16 * ks * n * (uint32_t)sizeof(bf16);
  p.w_bytes = p.chunk_bytes * (p.resident ? k * p.nkc : p.nstage);
  p.a_bytes = p.nap * cp * (uint32_t)sizeof(bf16);
  const int smem = (int)(p.w_bytes + p.abufs * p.a_bytes +
                         8 * (4 + 2 * p.nstage));
  // the plan must be the one this shape gives
  if (n % 8 || p.passes * n < C || cp < C || cp % (16 * ks) ||
      plan[kTt] != tt || p.na != tt + 2 * p.hc || p.nap != (p.na | 1) ||
      p.abufs < 1 || p.abufs > 2 || p.nstage < 1 ||
      (p.resident && p.passes != 1) || plan[kSmem] != smem ||
      smem > kSmemPerBlock ||
      grid > p.n_items)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
#define AMP_WGMMA_CASE(N_, KS_, NWG_, MT_, PW_, R_)                      \
  if (n == N_ && ks == KS_ && plan[kNwg] == NWG_ && plan[kMt] == MT_ &&   \
      plan[kPw] == PW_)                                                   \
    return launch<Cfg<N_, KS_, NWG_, MT_, PW_, R_>>(p, smem, grid, st);
  AMP_WGMMA_CONFIGS(AMP_WGMMA_CASE)
#undef AMP_WGMMA_CASE
  return (int)cudaErrorInvalidConfiguration;
}
