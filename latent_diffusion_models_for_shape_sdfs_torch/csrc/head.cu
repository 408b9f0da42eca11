// The bf16 decoder's scalar head (its last linear layer, C -> 1) on the
// autograd route, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves the head to XLA (the bf16
// branch of WNLinear in latent_diffusion_models_for_shape_sdfs_tpu/models/
// decoder.py, jnp.matmul with preferred_element_type=float32). Added because
// the plain form, F.linear(x.float(), bf16(w).float()) + b under autograd,
// makes five fp32 passes over [rows, C]: x's fp32 copy (kept alive until the
// backward), the GEMV, the K = 1 product dx = g . w, dW over the saved copy
// and dx's cast to bf16. These kernels read x once forward and read x and
// write dx once backward.
//
// Entries (wb = bf16(w) [C], b [1] fp32, C % 8 == 0, C <= MAX_COLS):
//   head_fwd_launch   pred[n] = sum_c x[n, c] * wb[c] + b, in fp32: each
//       product of two bf16 values is exact in fp32, so only the order of
//       the sum differs from the plain form's;
//   head_bwd_launch   from g [rows] fp32 (not rounded): dx[n, c] =
//       bf16(g[n] * wb[c]), the fp32 product rounded once more to bf16, as
//       the plain form's K = 1 product and cast give it; then one partial
//       row a CTA of the column sums of g[n] * x[n, c] and of g[n], and a
//       second launch that sums the partials into dw[c] = fp32(bf16(sum)),
//       as the cast's backward rounds the fp32 weight's gradient, and db.
//       A null dx, dw or db skips that output (and a null dw the read of x).
//
// Bound on this card: bytes. The forward reads 2 B an element (x), the
// backward 4 B (x in, dx out) plus g and the partials.
//
// Design: every access of x and dx is 16 bytes (8 columns).
//   forward: a warp takes FWD_ROWS rows; lane l reads chunks l, l + 32, ...
//     of each row, issuing the rows' loads together, and sums its chunks'
//     products in column order; the lanes' sums then meet by a butterfly
//     (xor 16, 8, 4, 2, 1), which leaves the same total on every lane.
//   backward: a fixed grid, as kernel #3b's row path: CTA b takes tiles of
//     BWD_ROWS rows b, b + G, ...; thread (lane, chunk) takes 8 columns of
//     rows lane, lane + lanes, ... of each tile, sums them in row order,
//     adds the tiles in order, and the CTA adds its lanes in order into one
//     partial row [C + 1] (the last entry g's); the reduction launch sums
//     the G partials of each column in a fixed order (RED_SLICES slices,
//     blocks of RED_BLOCK, a tree).
// No float atomics: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FWD_ROWS = 8;             // forward: rows a warp
constexpr int BWD_ROWS = 64;            // backward: rows a tile
constexpr int MAX_COLS = 8 * THREADS;   // a row's chunks fit one CTA
constexpr int RED_SLICES = 32;          // partials' reduction: slices
constexpr int RED_BLOCK = 16;           // ... each summed in blocks of 16

typedef __nv_bfloat16 bf16;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&v)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}

// pred[r] for the rows of each warp.
__global__ void __launch_bounds__(THREADS)
    head_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wb,
                    const float* __restrict__ b, float* __restrict__ pred,
                    long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long r0 =
      ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * FWD_ROWS;
  if (r0 >= rows) return;               // the whole warp
  const int nr = static_cast<int>(min((long long)FWD_ROWS, rows - r0));
  const int chunks = cols / 8;
  const bf16* xr = x + r0 * cols;
  float acc[FWD_ROWS] = {};
#pragma unroll 2
  for (int k = lane; k < chunks; k += 32) {
    uint4 q[FWD_ROWS];
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i)
      q[i] = i < nr ? __ldcs(reinterpret_cast<const uint4*>(
                          xr + (long long)i * cols + k * 8))
                    : make_uint4(0u, 0u, 0u, 0u);
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wb + k * 8)), w);
#pragma unroll
    for (int i = 0; i < FWD_ROWS; ++i) {
      float v[8];
      unpack8(q[i], v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i] = fmaf(v[j], w[j], acc[i]);
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < FWD_ROWS; ++i) {
#pragma unroll
    for (int m = 16; m >= 1; m /= 2)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], m);
    if (lane == i) mine = acc[i];
  }
  if (lane < nr) pred[r0 + lane] = mine + b[0];
}

// dx and the partial rows; thread (lane, chunk) = (tid / chunks,
// tid % chunks), lanes * chunks <= THREADS.
__global__ void __launch_bounds__(THREADS)
    head_bwd_kernel(const float* __restrict__ g, const bf16* __restrict__ x,
                    const bf16* __restrict__ wb, bf16* __restrict__ dx,
                    float* __restrict__ partials, long long rows, int cols,
                    int lanes) {
  __shared__ float sums[THREADS * 8];
  __shared__ float gsums[THREADS];
  const int chunks = cols / 8;
  const int lane = threadIdx.x / chunks, c0 = (threadIdx.x % chunks) * 8;
  const long long tiles = (rows + BWD_ROWS - 1) / BWD_ROWS;
  if (lane < lanes) {
    float w[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(wb + c0)), w);
    float outer[8] = {}, gouter = 0.f;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      float inner[8] = {}, ginner = 0.f;
      const long long r_end = min(rows, (t + 1) * BWD_ROWS);
#pragma unroll 4
      for (long long r = t * BWD_ROWS + lane; r < r_end; r += lanes) {
        const float gv = __ldg(g + r);
        const long long base = r * cols + c0;
        if (x != nullptr) {
          float v[8];
          unpack8(__ldg(reinterpret_cast<const uint4*>(x + base)), v);
#pragma unroll
          for (int j = 0; j < 8; ++j) inner[j] = fmaf(gv, v[j], inner[j]);
        }
        if (dx != nullptr) {
          uint4 q;
          bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(gv * w[j]);
          *reinterpret_cast<uint4*>(dx + base) = q;
        }
        ginner += gv;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) outer[j] += inner[j];
      gouter += ginner;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sums[lane * cols + c0 + j] = outer[j];
    if (c0 == 0) gsums[lane] = gouter;
  }
  __syncthreads();
  float* part = partials + (long long)blockIdx.x * (cols + 1);
  if (x != nullptr)
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      float s = sums[c];
      for (int l = 1; l < lanes; ++l) s += sums[l * cols + c];
      part[c] = s;
    }
  if (threadIdx.x == 0) {
    float s = gsums[0];
    for (int l = 1; l < lanes; ++l) s += gsums[l];
    part[cols] = s;
  }
}

// Columns [c_begin, c_end) of the n_part partial rows [cols + 1]: slice s
// of RED_SLICES sums its contiguous share in blocks of RED_BLOCK (in order,
// then the blocks in order), then the slices pairwise: s += s + w for
// w = 16, 8, 4, 2, 1. Column c < cols goes to dw[c] through bf16, column
// cols to db[0].
__global__ void __launch_bounds__(32 * RED_SLICES)
    head_reduce_kernel(const float* __restrict__ partials,
                       float* __restrict__ dw, float* __restrict__ db,
                       int n_part, int cols, int c_begin, int c_end) {
  __shared__ float s[RED_SLICES][33];
  const int cx = threadIdx.x, sy = threadIdx.y;
  const int c = c_begin + blockIdx.x * 32 + cx;
  const int per = (n_part + RED_SLICES - 1) / RED_SLICES;
  const int i_begin = sy * per, i_end = min(n_part, i_begin + per);
  float outer = 0.f;
  if (c < c_end) {
    for (int i0 = i_begin; i0 < i_end; i0 += RED_BLOCK) {
      float inner = 0.f;
      const int i1 = min(i0 + RED_BLOCK, i_end);
      for (int i = i0; i < i1; ++i)
        inner += partials[(long long)i * (cols + 1) + c];
      outer += inner;
    }
  }
  s[sy][cx] = outer;
  __syncthreads();
#pragma unroll
  for (int w = RED_SLICES / 2; w >= 1; w /= 2) {
    if (sy < w) s[sy][cx] += s[sy + w][cx];
    __syncthreads();
  }
  if (sy == 0 && c < c_end) {
    if (c < cols)
      dw[c] = __bfloat162float(__float2bfloat16_rn(s[0][cx]));
    else
      db[0] = s[0][cx];
  }
}

}  // namespace

extern "C" {

// x [rows, cols] bf16, wb [cols] bf16, b [1] fp32 -> pred [rows] fp32.
// Returns the cudaError_t of the launch (0 = success).
int head_fwd_launch(const void* x, const void* wb, const void* b, void* pred,
                    long long rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0 || cols % 8 || cols > MAX_COLS ||
      !aligned16(x) || !aligned16(wb))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      (rows + (long long)WARPS * FWD_ROWS - 1) / ((long long)WARPS * FWD_ROWS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  head_fwd_kernel<<<(unsigned)blocks, THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wb),
      static_cast<const float*>(b), static_cast<float*>(pred), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

// g [rows] fp32, x [rows, cols] bf16 (read only for dw), wb [cols] bf16 ->
// dx [rows, cols] bf16, dw [cols] fp32, db [1] fp32, each skipped where
// null, through `partials` [ctas, cols + 1] fp32; 0 < ctas <= the tiles
// of BWD_ROWS rows.
int head_bwd_launch(const void* g, const void* x, const void* wb, void* dx,
                    void* partials, void* dw, void* db, long long rows,
                    int cols, int ctas, void* stream) {
  const long long tiles = (rows + BWD_ROWS - 1) / BWD_ROWS;
  if (rows <= 0 || cols <= 0 || cols % 8 || cols > MAX_COLS || ctas <= 0 ||
      ctas > tiles || !aligned16(wb) || (dw != nullptr && x == nullptr) ||
      (x != nullptr && !aligned16(x)) || (dx != nullptr && !aligned16(dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = cols / 8;
  const int lanes = THREADS / chunks < BWD_ROWS ? THREADS / chunks : BWD_ROWS;
  head_bwd_kernel<<<ctas, THREADS, 0, s>>>(
      static_cast<const float*>(g),
      dw != nullptr ? static_cast<const bf16*>(x) : nullptr,
      static_cast<const bf16*>(wb), static_cast<bf16*>(dx),
      static_cast<float*>(partials), rows, cols, lanes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int c_begin = dw != nullptr ? 0 : cols;
  const int c_end = db != nullptr ? cols + 1 : cols;
  if (c_end > c_begin)
    head_reduce_kernel<<<(c_end - c_begin + 31) / 32, dim3(32, RED_SLICES), 0,
                         s>>>(static_cast<const float*>(partials),
                              static_cast<float*>(dw), static_cast<float*>(db),
                              ctas, cols, c_begin, c_end);
  return static_cast<int>(cudaGetLastError());
}

// The constants the wrapper's plan rests on: the backward's rows a tile
// (its grid) and the widest row.
void head_constants(int* out) {
  out[0] = BWD_ROWS;
  out[1] = MAX_COLS;
}

}  // extern "C"
