// Kernels #3 and #3b: relu + inverted dropout, forward and backward, for
// training.
//
// Replaces the TPU kernels `_relu_dropout_kernel` (forward, via
// `relu_dropout` -> `_relu_dropout_fwd_impl`) and `_mask_kernel` (backward,
// via `_relu_dropout_bwd`) in
// latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py.
//
// Entries (scale = 1/(1-rate) rounded to the output's type, keep iff the
// element's Philox word >= threshold; see philox.cuh):
//   relu_dropout_fwd_launch       y  = keep & (x > 0) ? T(x * scale) : 0
//   relu_dropout_bwd_launch       dx = keep & (x > 0) ? T(g * scale) : 0
//       the standalone pair on x of type T (f32 or bf16), the mask drawn
//       again in the backward;
//   bias_relu_dropout_fwd_launch  out = keep & (h > 0) ? bf16(h * scale) : 0,
//       h = bf16_rn(yf + b): the bf16 decoder's hidden layer, from its fp32
//       product yf [rows, H] (without bias) and the fp32 bias b [H]; the
//       bias add in fp32 and one rounding, then #3;
//   relu_dropout_bwd_out_launch   gb = out > 0 ? bf16(g * scale) : 0 and
//       db = column sums of gb in fp32: the layer's backward from its
//       output. For any rate in [0, 1), out > 0 <=> keep & (h > 0): a
//       positive h times scale >= 1 stays positive under round-to-nearest
//       (also as a subnormal, ftz off), and NaN, -0 and negatives give +0.
//       So gb equals the masked cotangent bit for bit with no Philox draw
//       and no saved pre-activation.
//
// Bound on this card: bytes. The layer's forward moves 6 B an element (fp32
// in, bf16 out), its backward 6 B (out and g in, gb out) plus the column
// partials; one Philox call (10 rounds of two 32-bit multiplies) serves 4
// elements of the forward.
//
// Design: every width on 16-byte global accesses.
//   row path (H % 8 == 0, 16-byte aligned pointers): a thread per (row,
//     8 columns): two 16-byte fp32 loads or one bf16, one 16-byte store;
//   tile path (any H): a CTA stages a tile of R rows (32, fewer only for
//     very wide rows; R % 8 == 0, so each tile's fp32 and bf16 spans
//     start on 16 bytes) through shared memory with 16-byte cp.async
//     copies and 16-byte stores (ragged ends scalar); the forward's
//     threads take (row, group of 4 columns) with a warp's lanes on 32
//     rows of one group, which an odd H puts on 32 banks, the backward's
//     a column each.
// The backward from the output runs a fixed grid: CTA b takes tiles b,
// b + G, b + 2G, ..., sums each column of a tile in a fixed order (lane l
// of L rows l, l + L, ..., then the lanes in order), adds the tiles in
// order, and writes one partial row; a second launch sums the G partials
// of each column in a fixed order (32 slices, blocks of 16, a tree). No
// float atomics: two launches give the same bits. ops/relu_dropout.py's
// `db_kernel_order` is that order in torch.
// Plain CUDA C++ (not Triton): the Philox code stays in one header shared
// with csrc/fused_train.cu, which must draw the same mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 32;           // tile paths' rows, fewer if wide
constexpr int SMEM_MAX = 227 * 1024;    // a block's dynamic shared memory
constexpr int ROW_BLOCKS = 132 * 32;    // row path: grid-stride beyond this
constexpr int RED_SLICES = 32;          // db reduction: slices per column
constexpr int RED_BLOCK = 16;           // ... summed in blocks of 16

enum Mode { FWD = 0, FWD_BIAS = 1, BWD_X = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements, 16-byte aligned: two float4 or one uint4.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const bf16* e = reinterpret_cast<const bf16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const bf16 (&v)[8]) {
  uint4 q;
  bf16* e = reinterpret_cast<bf16*>(&q);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = v[j];
  *reinterpret_cast<uint4*>(p) = q;
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const uint32_t sa = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Elements before the first 16-byte boundary of a span at p.
template <typename T>
__host__ __device__ __forceinline__ int lead(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// A shared-memory buffer of `cap` elements, with room to start at any lead.
template <typename T>
__host__ __device__ __forceinline__ int region(int cap) {
  return (cap * static_cast<int>(sizeof(T)) + 16 + 15) & ~15;
}

// n elements of the span at g into s, where s + i and g + i share their
// address mod 16 (the caller offsets s by lead(g)): 16-byte cp.async for
// the aligned middle, scalar copies for the ragged ends. Wait with
// cp_async_wait_all() and a barrier.
template <typename T>
__device__ __forceinline__ void copy_in(T* s, const T* __restrict__ g, int n) {
  constexpr int V = 16 / sizeof(T);
  const int head = min(n, (V - lead<T>(g)) % V);
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += THREADS) s[i] = g[i];
  for (int k = threadIdx.x; k < nv; k += THREADS)
    cp_async16(s + head + k * V, g + head + k * V);
  for (int i = head + nv * V + threadIdx.x; i < n; i += THREADS) s[i] = g[i];
}

// n elements of s to the span at g: 16-byte stores where s and g share
// their alignment, else scalar stores.
template <typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ g, const T* s,
                                         int n) {
  constexpr int V = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(g) - reinterpret_cast<uintptr_t>(s)) % 16) {
    for (int i = threadIdx.x; i < n; i += THREADS) g[i] = s[i];
    return;
  }
  const int head = min(n, (V - lead<T>(g)) % V);
  const int nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += THREADS) g[i] = s[i];
  for (int k = threadIdx.x; k < nv; k += THREADS)
    *reinterpret_cast<uint4*>(g + head + k * V) =
        *reinterpret_cast<const uint4*>(s + head + k * V);
  for (int i = head + nv * V + threadIdx.x; i < n; i += THREADS) g[i] = s[i];
}

// One element of the Philox entries: `a` is x (FWD, BWD_X) or the fp32
// product (FWD_BIAS), `gv` the cotangent (BWD_X).
template <int MODE, typename Out>
__device__ __forceinline__ Out drop_one(float a, float bias, float gv,
                                        uint32_t word, uint32_t threshold,
                                        float scale) {
  const float v = MODE == FWD_BIAS
                      ? __bfloat162float(__float2bfloat16_rn(a + bias))
                      : a;
  const bool keep = word >= threshold && v > 0.f;
  return from_f<Out>(keep ? (MODE == BWD_X ? gv : v) * scale : 0.f);
}

// ---------------------------------------------------------------- forward
// (and the standalone x-reading backward)

template <int MODE, typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
    drop_rows_kernel(const In* __restrict__ x, const float* __restrict__ bias,
                     const In* __restrict__ g, Out* __restrict__ out,
                     long long rows, int cols, uint32_t key,
                     uint32_t threshold, float scale) {
  const int chunks = cols / 8;
  const long long total = rows * chunks;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long t = (long long)blockIdx.x * THREADS + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / chunks;
    const int c0 = static_cast<int>(t - r * chunks) * 8;
    const long long base = r * cols + c0;
    float a[8], gv[8] = {}, bv[8] = {};
    load8(x + base, a);
    if (MODE == BWD_X) load8(g + base, gv);
    if (MODE == FWD_BIAS) load8(bias + c0, bv);
    const uint4 w0 = philox::dropout_bits(r, c0 / 4, key);
    const uint4 w1 = philox::dropout_bits(r, c0 / 4 + 1, key);
    Out o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[j] = drop_one<MODE, Out>(a[j], bv[j], gv[j],
                                 philox::word(j < 4 ? w0 : w1, j & 3),
                                 threshold, scale);
    store8(out + base, o);
  }
}

template <int MODE, typename In, typename Out>
__host__ __device__ __forceinline__ int drop_tile_inputs(int cap) {
  return region<In>(cap) * (MODE == BWD_X ? 2 : 1);
}

template <int MODE, typename In, typename Out>
__host__ __device__ __forceinline__ int drop_tile_smem(int cap) {
  return drop_tile_inputs<MODE, In, Out>(cap) + region<Out>(cap);
}

// One tile of tile_rows rows (a power of two, 32 at 253 wide) a CTA.
// Item k is row k % tile_rows, group k / tile_rows: a warp's lanes on 32
// rows of one group, which an odd H puts on 32 banks. The row and group
// come by mask and shift, and the column bound is tested once a group: a
// division per item and a test per element cost #3 ~12% at 253 wide,
// more than its Philox draws (~3%).
template <int MODE, typename In, typename Out>
__global__ void __launch_bounds__(THREADS)
    drop_tile_kernel(const In* __restrict__ x, const float* __restrict__ bias,
                     const In* __restrict__ g, Out* __restrict__ out,
                     long long rows, int cols, int tile_rows, uint32_t key,
                     uint32_t threshold, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = tile_rows * cols;
  const int log_rows = __ffs(tile_rows) - 1;
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nr = static_cast<int>(min((long long)tile_rows, rows - r0));
  const long long e0 = r0 * cols;
  const int n = nr * cols;
  In* sx = reinterpret_cast<In*>(smem) + lead<In>(x + e0);
  In* sg = MODE == BWD_X ? reinterpret_cast<In*>(smem + region<In>(cap)) +
                               lead<In>(g + e0)
                         : nullptr;
  Out* so = reinterpret_cast<Out*>(smem +
                                   drop_tile_inputs<MODE, In, Out>(cap)) +
            lead<Out>(out + e0);
  copy_in(sx, x + e0, n);
  if (MODE == BWD_X) copy_in(sg, g + e0, n);
  cp_async_wait_all();
  __syncthreads();
  const int groups = (cols + 3) / 4;
  for (int it = threadIdx.x; it < tile_rows * groups; it += THREADS) {
    const int rr = it & (tile_rows - 1), gi = it >> log_rows;
    if (rr >= nr) continue;
    const uint4 bits = philox::dropout_bits(r0 + rr, gi, key);
    const int c0 = gi * 4, i0 = rr * cols + c0;
    const int m = cols - c0 < 4 ? cols - c0 : 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= m) break;
      so[i0 + j] = drop_one<MODE, Out>(
          to_f(sx[i0 + j]), MODE == FWD_BIAS ? __ldg(bias + c0 + j) : 0.f,
          MODE == BWD_X ? to_f(sg[i0 + j]) : 0.f, philox::word(bits, j),
          threshold, scale);
    }
  }
  __syncthreads();
  copy_out(out + e0, so, n);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int MODE, typename In, typename Out>
int launch_drop(const void* x, const void* bias, const void* g, void* out,
                long long rows, int cols, uint32_t key, uint32_t threshold,
                float scale, cudaStream_t stream) {
  if (rows < 0 || cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const In* xp = static_cast<const In*>(x);
  const In* gp = static_cast<const In*>(g);
  const float* bp = static_cast<const float*>(bias);
  Out* op = static_cast<Out*>(out);
  const bool vec = cols % 8 == 0 && aligned16(x) && aligned16(out) &&
                   (MODE != BWD_X || aligned16(g)) &&
                   (MODE != FWD_BIAS || aligned16(bias));
  if (vec) {
    const long long total = rows * (cols / 8);
    long long blocks = (total + THREADS - 1) / THREADS;
    if (blocks > ROW_BLOCKS) blocks = ROW_BLOCKS;
    drop_rows_kernel<MODE, In, Out><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xp, bp, gp, op, rows, cols, key, threshold, scale);
    return static_cast<int>(cudaGetLastError());
  }
  // 32 rows a tile, or 16 or 8 where wide rows do not fit
  int tile_rows = TILE_ROWS;
  while (tile_rows >= 8 &&
         drop_tile_smem<MODE, In, Out>(tile_rows * cols) > SMEM_MAX)
    tile_rows /= 2;
  if (tile_rows < 8) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = drop_tile_smem<MODE, In, Out>(tile_rows * cols);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        drop_tile_kernel<MODE, In, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  drop_tile_kernel<MODE, In, Out><<<(unsigned)tiles, THREADS, smem, stream>>>(
      xp, bp, gp, op, rows, cols, tile_rows, key, threshold, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ backward from the output

__device__ __forceinline__ bf16 grad_one(float o, float gv, float scale) {
  return __float2bfloat16_rn(o > 0.f ? gv * scale : 0.f);
}

// Row path: tile_rows rows a tile; thread (lane, chunk) = (tid / chunks,
// tid % chunks) takes 8 columns of rows lane, lane + lanes, ... of each
// tile; lanes * chunks <= THREADS.
__global__ void __launch_bounds__(THREADS)
    bwd_out_rows_kernel(const bf16* __restrict__ out,
                        const bf16* __restrict__ g, bf16* __restrict__ gb,
                        float* __restrict__ partials, long long rows,
                        int cols, int tile_rows, int lanes, float scale) {
  __shared__ float sums[THREADS * 8];
  const int chunks = cols / 8;
  const int lane = threadIdx.x / chunks, c0 = (threadIdx.x % chunks) * 8;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  if (lane < lanes) {
    float outer[8] = {};
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      float inner[8] = {};
      const long long r_end = min(rows, (t + 1) * tile_rows);
#pragma unroll 4
      for (long long r = t * tile_rows + lane; r < r_end; r += lanes) {
        const long long base = r * cols + c0;
        float o[8], gv[8];
        load8(out + base, o);
        load8(g + base, gv);
        bf16 d[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          d[j] = grad_one(o[j], gv[j], scale);
          inner[j] += __bfloat162float(d[j]);
        }
        store8(gb + base, d);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) outer[j] += inner[j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) sums[lane * cols + c0 + j] = outer[j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    float s = sums[c];
    for (int l = 1; l < lanes; ++l) s += sums[l * cols + c];
    partials[(long long)blockIdx.x * cols + c] = s;
  }
}

__host__ __device__ __forceinline__ int bwd_tile_smem(int tile_rows,
                                                      int cols) {
  return 2 * region<bf16>(tile_rows * cols) + 4 * cols;
}

// Tile path: a thread per column of each staged tile, rows in order; gb
// is written over g's tile in shared memory.
__global__ void __launch_bounds__(THREADS)
    bwd_out_tile_kernel(const bf16* __restrict__ out,
                        const bf16* __restrict__ g, bf16* __restrict__ gb,
                        float* __restrict__ partials, long long rows,
                        int cols, int tile_rows, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cap = tile_rows * cols;
  float* acc = reinterpret_cast<float*>(smem + 2 * region<bf16>(cap));
  for (int c = threadIdx.x; c < cols; c += THREADS) acc[c] = 0.f;
  const long long tiles = (rows + tile_rows - 1) / tile_rows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * tile_rows;
    const int nr = static_cast<int>(min((long long)tile_rows, rows - r0));
    const long long e0 = r0 * cols;
    const int n = nr * cols;
    bf16* so = reinterpret_cast<bf16*>(smem) + lead<bf16>(out + e0);
    bf16* sg = reinterpret_cast<bf16*>(smem + region<bf16>(cap)) +
               lead<bf16>(g + e0);
    __syncthreads();              // the last tile's stores have read sg
    copy_in(so, out + e0, n);
    copy_in(sg, g + e0, n);
    cp_async_wait_all();
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += THREADS) {
      float inner = 0.f;
      for (int r = 0; r < nr; ++r) {
        const int i = r * cols + c;
        const bf16 d = grad_one(to_f(so[i]), to_f(sg[i]), scale);
        sg[i] = d;
        inner += __bfloat162float(d);
      }
      acc[c] += inner;
    }
    __syncthreads();
    copy_out(gb + e0, sg, n);
  }
  for (int c = threadIdx.x; c < cols; c += THREADS)
    partials[(long long)blockIdx.x * cols + c] = acc[c];
}

// db[c] = the n_part partials of column c: slice s of RED_SLICES sums its
// contiguous share in blocks of RED_BLOCK (in order, then the blocks in
// order), then the slices pairwise: s += s + w for w = 16, 8, 4, 2, 1.
__global__ void __launch_bounds__(32 * RED_SLICES)
    colsum_reduce_kernel(const float* __restrict__ partials,
                         float* __restrict__ db, int n_part, int cols) {
  __shared__ float s[RED_SLICES][33];
  const int cx = threadIdx.x, sy = threadIdx.y;
  const int c = blockIdx.x * 32 + cx;
  const int per = (n_part + RED_SLICES - 1) / RED_SLICES;
  const int i_begin = sy * per, i_end = min(n_part, i_begin + per);
  float outer = 0.f;
  if (c < cols) {
    for (int i0 = i_begin; i0 < i_end; i0 += RED_BLOCK) {
      float inner = 0.f;
      const int i1 = min(i0 + RED_BLOCK, i_end);
      for (int i = i0; i < i1; ++i) inner += partials[(long long)i * cols + c];
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
  if (sy == 0 && c < cols) db[c] = s[0][cx];
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
    return launch_drop<FWD, float, float>(x, nullptr, nullptr, out, rows,
                                          cols, key, threshold, scale, s);
  if (dtype == 1)
    return launch_drop<FWD, bf16, bf16>(x, nullptr, nullptr, out, rows, cols,
                                        key, threshold, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int relu_dropout_bwd_launch(const void* x, const void* g, void* dx,
                            long long rows, int cols, int dtype, unsigned key,
                            unsigned threshold, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_drop<BWD_X, float, float>(x, nullptr, g, dx, rows, cols, key,
                                            threshold, scale, s);
  if (dtype == 1)
    return launch_drop<BWD_X, bf16, bf16>(x, nullptr, g, dx, rows, cols, key,
                                          threshold, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// yf [rows, cols] fp32, b [cols] fp32 -> out [rows, cols] bf16; `scale` is
// 1/(1-rate) rounded to bf16.
int bias_relu_dropout_fwd_launch(const void* yf, const void* b, void* out,
                                 long long rows, int cols, unsigned key,
                                 unsigned threshold, float scale,
                                 void* stream) {
  return launch_drop<FWD_BIAS, float, bf16>(
      yf, b, nullptr, out, rows, cols, key, threshold, scale,
      static_cast<cudaStream_t>(stream));
}

// out, g -> gb [rows, cols] bf16 and db [cols] fp32, through `partials`
// [ctas, cols] fp32. The plan (ops/relu_dropout.py `bwd_plan`): vec (the
// row path; cols % 8 == 0, 16-byte aligned out, g, gb), tile_rows (a
// multiple of 8), lanes (row path; lanes * cols / 8 <= 256), ctas.
int relu_dropout_bwd_out_launch(const void* out, const void* g, void* gb,
                                void* partials, void* db, long long rows,
                                int cols, float scale, int vec, int tile_rows,
                                int lanes, int ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles =
      tile_rows > 0 ? (rows + tile_rows - 1) / tile_rows : 0;
  if (rows <= 0 || cols <= 0 || tile_rows <= 0 || tile_rows % 8 ||
      ctas <= 0 || ctas > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* op = static_cast<const bf16*>(out);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* gbp = static_cast<bf16*>(gb);
  float* pp = static_cast<float*>(partials);
  if (vec) {
    if (cols % 8 || lanes < 1 || lanes * (cols / 8) > THREADS ||
        !aligned16(out) || !aligned16(g) || !aligned16(gb))
      return static_cast<int>(cudaErrorInvalidValue);
    bwd_out_rows_kernel<<<ctas, THREADS, 0, s>>>(op, gp, gbp, pp, rows, cols,
                                                 tile_rows, lanes, scale);
  } else {
    const int smem = bwd_tile_smem(tile_rows, cols);
    if (lanes != 1 || smem > SMEM_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          bwd_out_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    bwd_out_tile_kernel<<<ctas, THREADS, smem, s>>>(op, gp, gbp, pp, rows,
                                                    cols, tile_rows, scale);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  colsum_reduce_kernel<<<(cols + 31) / 32, dim3(32, RED_SLICES), 0, s>>>(
      pp, static_cast<float*>(db), ctas, cols);
  return static_cast<int>(cudaGetLastError());
}

// The constants the wrapper's plan and model of the db order rest on.
void relu_dropout_constants(int* out) {
  out[0] = THREADS;
  out[1] = TILE_ROWS;
  out[2] = SMEM_MAX;
  out[3] = RED_SLICES;
  out[4] = RED_BLOCK;
}

}  // extern "C"
