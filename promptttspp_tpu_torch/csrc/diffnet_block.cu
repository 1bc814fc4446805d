// The elementwise work of the DiffNet's residual blocks in a decode, folded
// into three passes around the block's two float32 library products (the
// cuDNN dilated convolution and the cuBLAS 1x1 output projection):
//
//   G0 (entry):    h [B,T,R] -> x = relu(h) [B,T,R] and the first block's
//                  convolution input u = x + dp0 as [B,R,T];
//   G1 (gate):     c [B,2R,T] (the convolution, its bias apart) ->
//                  z = sigmoid(c_g + b_g + p_g) * tanh(c_f + b_f + p_f)
//                  as [B,R,T] (the layout eager PyTorch gives it, so the
//                  output projection is the same cuBLAS call), p the
//                  hoisted conditioner projection [B,T,2R];
//   G2 (residual): o [B,T,2R] (the projection, its bias apart) ->
//                  x = (x + o_r + b_r) * inv_scale, skip += o_s + b_s (or
//                  0 + o_s + b_s at the first block), both in place, and
//                  the next block's convolution input u = x + dp as [B,R,T].
//
// No JAX pallas_call has them: XLA fuses this glue around the products
// itself. Eager PyTorch ran it as about nine passes a block over float32
// tensors of [B,T,R..2R], several of them strided (the convolution works on
// [B,C,T], the model's tensors are [B,T,C]). Bound by bytes: each input is
// read once and each output written once, a few flops an element. Design:
// tiles of 32 frames by 32 channels, 256 threads; every global access of a
// warp is one 128-byte row (frames or channels, whichever is contiguous),
// and the one operand of each kernel that has the other layout (G1's p,
// G0's and G2's u) goes through a padded shared-memory tile.
//
// Numerics: the float32 operations torch's own kernels do, in torch's order
// and rounding, so the decode's bits do not change: the bias adds as
// separate roundings (cuDNN's and cuBLAS's callers add the bias in a pass
// of their own), sigmoid as 1 / (1 + expf(-g)), tanhf, relu as
// max(v, 0) with NaN kept, a Python-float divisor as torch's CUDA division
// applies it (a multiply by its float32 reciprocal, inv_scale, computed by
// the caller), the first skip as 0 + s. Every add and multiply is an _rn
// intrinsic, so the compiler contracts none of them into an fma; the file
// is built without fast math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;  // frames and channels of a tile
constexpr int ROWS = 8;   // warps of a block: warp w takes rows w, w + 8, ...
constexpr int PER = TILE / ROWS;  // rows of a tile per thread

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float sigmoid(float g) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
}

// Write the tile st[t][r] (frames t0.., channels r0..) to u [B,R,T] of
// batch row b.
__device__ __forceinline__ void store_channel_major(
    float (*st)[TILE + 1], float* u, int b, int t0, int r0, int T,
    int R) {
  const int t = t0 + threadIdx.x;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS, r = r0 + i;
    if (r < R && t < T) u[((size_t)b * R + r) * T + t] = st[threadIdx.x][i];
  }
}

// Each kernel issues all of a thread's loads before it uses any of them,
// so each thread keeps PER rows of every input in flight.

__global__ void __launch_bounds__(TILE * ROWS)
entry_kernel(const float* __restrict__ h, const float* __restrict__ dp,
             float* __restrict__ x, float* __restrict__ u, int T, int R) {
  __shared__ float st[TILE][TILE + 1];
  const int b = blockIdx.z, t0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const int r = r0 + threadIdx.x;
  const float d = r < R ? dp[(size_t)b * R + r] : 0.f;
  float v[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = t0 + threadIdx.y + j * ROWS;
    if (r < R && t < T) v[j] = h[((size_t)b * T + t) * R + r];
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS, t = t0 + i;
    if (r < R && t < T) {
      const float a = v[j] != v[j] ? v[j] : fmaxf(v[j], 0.f);  // NaN kept
      x[((size_t)b * T + t) * R + r] = a;
      st[i][threadIdx.x] = __fadd_rn(a, d);
    }
  }
  __syncthreads();
  store_channel_major(st, u, b, t0, r0, T, R);
}

template <typename P>
__global__ void __launch_bounds__(TILE * ROWS)
gate_kernel(const float* __restrict__ c, const float* __restrict__ bias,
            const P* __restrict__ p, long long p_batch,
            float* __restrict__ z, int T, int R) {
  __shared__ float pg[TILE][TILE + 1], pf[TILE][TILE + 1];
  const int b = blockIdx.z, t0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  // this thread's rows of the convolution (frames along the warp) and of
  // the conditioner projection (channels along the warp)
  const int tc = t0 + threadIdx.x, rp = r0 + threadIdx.x;
  float cg[PER], cf[PER], qg[PER], qf[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS;
    if (r0 + i < R && tc < T) {
      const float* row = c + ((size_t)b * 2 * R + r0 + i) * T + tc;
      cg[j] = row[0];
      cf[j] = row[(size_t)R * T];
    }
    if (t0 + i < T && rp < R) {
      const P* row = p + b * p_batch + (size_t)(t0 + i) * 2 * R + rp;
      qg[j] = load(row);
      qf[j] = load(row + R);
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS;
    if (t0 + i < T && rp < R) {
      pg[i][threadIdx.x] = qg[j];
      pf[i][threadIdx.x] = qf[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS, r = r0 + i;
    if (r < R && tc < T) {
      float g = cg[j], f = cf[j];
      if (bias != nullptr) {
        g = __fadd_rn(g, bias[r]);
        f = __fadd_rn(f, bias[R + r]);
      }
      g = __fadd_rn(g, pg[threadIdx.x][i]);
      f = __fadd_rn(f, pf[threadIdx.x][i]);
      z[((size_t)b * R + r) * T + tc] = __fmul_rn(sigmoid(g), tanhf(f));
    }
  }
}

__global__ void __launch_bounds__(TILE * ROWS)
residual_kernel(const float* __restrict__ o, const float* __restrict__ bias,
                float* __restrict__ x, float* __restrict__ skip, int first,
                const float* __restrict__ dp, float* __restrict__ u,
                float inv_scale, int T, int R) {
  __shared__ float st[TILE][TILE + 1];
  const int b = blockIdx.z, t0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
  const int r = r0 + threadIdx.x;
  const bool in = r < R;
  const float br = in ? bias[r] : 0.f, bs = in ? bias[R + r] : 0.f;
  const float d = (in && dp != nullptr) ? dp[(size_t)b * R + r] : 0.f;
  float orr[PER], os[PER], xv[PER], sv[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int t = t0 + threadIdx.y + j * ROWS;
    if (in && t < T) {
      const float* row = o + ((size_t)b * T + t) * 2 * R + r;
      const size_t k = ((size_t)b * T + t) * R + r;
      orr[j] = row[0];
      os[j] = row[R];
      xv[j] = x[k];
      sv[j] = first ? 0.f : skip[k];
    }
  }
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int i = threadIdx.y + j * ROWS, t = t0 + i;
    if (in && t < T) {
      const size_t k = ((size_t)b * T + t) * R + r;
      const float xn =
          __fmul_rn(__fadd_rn(xv[j], __fadd_rn(orr[j], br)), inv_scale);
      x[k] = xn;
      skip[k] = __fadd_rn(sv[j], __fadd_rn(os[j], bs));  // 0 + s first
      st[i][threadIdx.x] = __fadd_rn(xn, d);
    }
  }
  if (u == nullptr) return;
  __syncthreads();
  store_channel_major(st, u, b, t0, r0, T, R);
}

bool bad_shape(int B, int T, int R) {
  return B <= 0 || T <= 0 || R <= 0 || B > 65535 ||
         (R + TILE - 1) / TILE > 65535;
}

dim3 grid_of(int B, int T, int R) {
  return dim3((T + TILE - 1) / TILE, (R + TILE - 1) / TILE, B);
}

}  // namespace

extern "C" int diffnet_entry(const float* h, const float* dp, float* x,
                             float* u, int B, int T, int R, void* stream) {
  if (bad_shape(B, T, R)) return (int)cudaErrorInvalidValue;
  entry_kernel<<<grid_of(B, T, R), dim3(TILE, ROWS), 0,
                 (cudaStream_t)stream>>>(h, dp, x, u, T, R);
  return (int)cudaGetLastError();
}

extern "C" int diffnet_gate(const float* c, const float* bias, const void* p,
                            int p_bf16, long long p_batch, float* z, int B,
                            int T, int R, void* stream) {
  if (bad_shape(B, T, R)) return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, T, R), block(TILE, ROWS);
  if (p_bf16)
    gate_kernel<__nv_bfloat16><<<grid, block, 0, (cudaStream_t)stream>>>(
        c, bias, (const __nv_bfloat16*)p, p_batch, z, T, R);
  else
    gate_kernel<float><<<grid, block, 0, (cudaStream_t)stream>>>(
        c, bias, (const float*)p, p_batch, z, T, R);
  return (int)cudaGetLastError();
}

extern "C" int diffnet_residual(const float* o, const float* bias, float* x,
                                float* skip, int first, const float* dp,
                                float* u, float inv_scale, int B, int T,
                                int R, void* stream) {
  if (bad_shape(B, T, R) || (dp == nullptr) != (u == nullptr))
    return (int)cudaErrorInvalidValue;
  residual_kernel<<<grid_of(B, T, R), dim3(TILE, ROWS), 0,
                    (cudaStream_t)stream>>>(o, bias, x, skip, first, dp, u,
                                            inv_scale, T, R);
  return (int)cudaGetLastError();
}
