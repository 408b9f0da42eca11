// Fused relu + inverted dropout, forward and backward, for training.
//
// Replaces the TPU kernels `_relu_dropout_kernel` (forward, via
// `relu_dropout` -> `_relu_dropout_fwd_impl`) and `_mask_kernel` (backward,
// via `_relu_dropout_bwd`) in
// latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py.
//
//   forward : y  = keep & (x > 0) ? x * scale : 0
//   backward: dx = keep & (x > 0) ? g * scale : 0     (g already in x's type)
// with scale = 1/(1-rate) rounded to x's type, the product rounded to x's
// type (bf16 or f32), and the comparison made in f32. The mask is not
// stored: the backward regenerates it from the seed (philox.cuh gives the
// counter scheme), as the TPU kernel regenerates it from its hardware PRNG.
// The TPU's bits cannot be reproduced; the port's bits are Philox4x32-10,
// the same in ops/relu_dropout.dropout_keep_bits (the plain version),
// so kernel and plain version agree bit for bit.
//
// Bound on this card: bytes. The forward moves 4 B per bf16 element (read
// x, write y), the backward 6 B (read x and g, write dx); one Philox call
// (10 rounds of two 32-bit multiplies) serves 4 elements, far below the
// integer rate needed to keep up with 3.35 TB/s.
//
// Design: one thread per group of 4 columns of a row (one Philox call),
// grid-stride; 8-byte (bf16) or 16-byte (f32) vector loads and stores when
// the row width is a multiple of 4 and the pointers are aligned, else
// scalar accesses (the 253-wide layer before the skip). Plain CUDA C++;
// Triton would serve as well for one elementwise pass, but this keeps the
// Philox code in one header shared with csrc/fused_train.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four elements in one access: float4 for f32, uint2 (4 x bf16) for bf16.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  using V = typename Vec4<T>::type;
  const V q = *reinterpret_cast<const V*>(p);
  const T* e = reinterpret_cast<const T*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = e[j];
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const T (&v)[4]) {
  using V = typename Vec4<T>::type;
  V q;
  T* e = reinterpret_cast<T*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = v[j];
  *reinterpret_cast<V*>(p) = q;
}

// BWD=false: out = f(x); BWD=true: out = f(x, g). VEC: 4-wide accesses.
template <typename T, bool BWD, bool VEC>
__global__ void __launch_bounds__(THREADS)
    relu_dropout_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        T* __restrict__ out, long long rows, int cols,
                        uint32_t key, uint32_t threshold, float scale) {
  const int groups = (cols + 3) / 4;
  const long long total = rows * groups;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / groups;
    const int gi = static_cast<int>(t - r * groups);
    const uint4 bits = philox::dropout_bits(r, static_cast<uint32_t>(gi), key);
    const int c0 = gi * 4;
    const long long base = r * cols + c0;
    const int n = cols - c0 < 4 ? cols - c0 : 4;
    T xv[4], gv[4], ov[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = gv[j] = from_f<T>(0.f);
    if (VEC) {
      load4(x + base, xv);
      if (BWD) load4(g + base, gv);
    } else {
      for (int j = 0; j < n; ++j) {
        xv[j] = x[base + j];
        if (BWD) gv[j] = g[base + j];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = philox::word(bits, j) >= threshold && to_f(xv[j]) > 0.f;
      const float v = BWD ? to_f(gv[j]) : to_f(xv[j]);
      ov[j] = from_f<T>(keep ? v * scale : 0.f);
    }
    if (VEC) {
      store4(out + base, ov);
    } else {
      for (int j = 0; j < n; ++j) out[base + j] = ov[j];
    }
  }
}

template <typename T, bool BWD>
int launch_typed(const void* x, const void* g, void* out, long long rows,
                 int cols, uint32_t key, uint32_t threshold, float scale,
                 cudaStream_t stream) {
  const long long total = rows * ((cols + 3) / 4);
  if (total == 0) return 0;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond this
  const bool vec = cols % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (!BWD || reinterpret_cast<uintptr_t>(g) % 16 == 0);
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  if (vec)
    relu_dropout_kernel<T, BWD, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xp, gp, op, rows, cols, key, threshold, scale);
  else
    relu_dropout_kernel<T, BWD, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xp, gp, op, rows, cols, key, threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. `scale` is 1/(1-rate) already rounded
// to that type. Returns the cudaError_t of the launch (0 = success).
int relu_dropout_fwd_launch(const void* x, void* out, long long rows, int cols,
                            int dtype, unsigned key, unsigned threshold,
                            float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float, false>(x, nullptr, out, rows, cols, key,
                                      threshold, scale, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, false>(x, nullptr, out, rows, cols, key,
                                              threshold, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int relu_dropout_bwd_launch(const void* x, const void* g, void* dx,
                            long long rows, int cols, int dtype, unsigned key,
                            unsigned threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float, true>(x, g, dx, rows, cols, key, threshold,
                                     scale, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16, true>(x, g, dx, rows, cols, key,
                                             threshold, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
