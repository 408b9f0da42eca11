// Fused SDF-decoder evaluation for one latent over a batch of points.
//
// Replaces the TPU kernel `_build_eval_kernel` / `make_pallas_apply` in
// latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py.
//
// What it computes, for a tile of TILE_M points (xyz [N,3] f32, rows >= N
// masked):
//   layer 0      : h = bf16(relu(bf16(xyz) . w_x + row0))        CUDA cores (K=3)
//   hidden layer : h = bf16(relu(h @ W^T [+ bf16(xyz) . w_x] + row))  tensor cores
//   final layer  : sdf = h . w + row, optional tanh               CUDA cores
// `row` is the layer's f32 bias row; for layer 0 and the skip layer the
// wrapper has already added the hoisted latent product b + bf16(z) @ w_z
// (as the TPU kernel's caller does), so the kernel sees only per-point
// math. Products are bf16 x bf16 with f32 accumulation (mma.sync
// m16n8k16), and every hidden activation is re-rounded to bf16, exactly
// the arithmetic of ops/fused_decoder.py::fast_apply in bf16 (the plain
// version this kernel is tested against).
//
// Bound on this card: ~3.15 MFLOP per point for the canonical 8x512
// decoder against 24 bytes of input/output per point, so the work is
// compute-bound (989 TFLOP/s bf16 -> ~3.2 ms per 2^20 points).
//
// Design:
//  * Activations stay on chip: the tile's activations live in two
//    ping-pong buffers in dynamic shared memory (2 x 64 x 520 bf16 =
//    130 KB; rows padded by 8 elements so ldmatrix and the epilogue's
//    stores are free of bank conflicts). Nothing between layers touches
//    device memory.
//  * Weights are streamed, not resident: one 512x512 bf16 layer (512 KB)
//    is larger than a block's shared memory, but all folded weights
//    (~3.1 MB) stay hot in the 50 MB L2. The wrapper stores each hidden
//    weight in mma fragment order, so each lane reads its B fragments for
//    two n8 tiles with one coalesced 16-byte load straight into registers,
//    prefetched two k-steps ahead. No shared memory and no barrier is
//    spent on weights.
//  * Each of the 8 warps owns a strip of output columns for all 64 rows,
//    so every weight element is read once per tile; the A fragments come
//    from shared memory through ldmatrix.
//  * Widths are padded by the wrapper to multiples of 64 with zero rows and
//    columns (253 -> 256): relu(0) = 0 contributes nothing downstream.
//
// What bounds it today: the weights are re-read from L2 for every 64-point
// tile (64 FLOP per L2 byte), so L2 bandwidth, not the tensor cores, is the
// expected limit. Larger tiles (wgmma, clusters sharing weights through
// TMA multicast) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_WIDTH = 512;
constexpr int ACT_STRIDE = MAX_WIDTH + 8;  // bf16 elements per smem row
constexpr int MAX_LAYERS = 16;
constexpr size_t SMEM_BYTES =
    2 * TILE_M * ACT_STRIDE * sizeof(__nv_bfloat16) + TILE_M * 3 * sizeof(float);

struct LayerDesc {
  int k;             // padded input width of the hidden product (0: layer 0)
  int n;             // padded output width (1: final layer)
  long long w_off;   // bf16 offset of the weights in w_all
  long long row_off; // f32 offset of the bias row in rows
  long long x_off;   // bf16 offset of w_x [n,3] in wx_all, or -1
};

struct Plan {
  int n_layers;
  int use_tanh;
  LayerDesc layers[MAX_LAYERS];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float xterm(const float* xs, int m,
                                       const __nv_bfloat16* wx, int col) {
  return xs[m * 3] * __bfloat162float(wx[col * 3]) +
         xs[m * 3 + 1] * __bfloat162float(wx[col * 3 + 1]) +
         xs[m * 3 + 2] * __bfloat162float(wx[col * 3 + 2]);
}

// B fragments of NT n8 tiles (NT/2 tile pairs) for k-step kt. Weight layout
// (wrapper-made): [n/16 pairs][k/16 steps][32 lanes] of uint4, where a lane's
// uint4 holds {b0, b1} of the even tile and {b0, b1} of the odd tile.
template <int NT>
__device__ __forceinline__ void load_b(uint4 (&b)[NT / 2], const uint4* wp,
                                       int kt, int kts) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) b[p] = __ldg(wp + ((size_t)p * kts + kt) * 32);
}

template <int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[4][NT][4],
                                          const __nv_bfloat16* a_s, int kt,
                                          const uint4 (&b)[NT / 2], int lane) {
  const __nv_bfloat16* base =
      a_s + (lane % 16) * ACT_STRIDE + kt * 16 + (lane / 16) * 8;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t a[4];
    ldmatrix_x4(a, base + mt * 16 * ACT_STRIDE);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint4& q = b[nt / 2];
      if (nt % 2 == 0)
        mma_bf16(acc[mt][nt], a, q.x, q.y);
      else
        mma_bf16(acc[mt][nt], a, q.z, q.w);
    }
  }
}

// One hidden layer: d_s[64, n] = bf16(relu(a_s[64, k] @ W^T (+ xterm) + row)).
// Warps walk strips of NT*8 output columns.
template <int NT>
__device__ void hidden_layer(const __nv_bfloat16* a_s, __nv_bfloat16* d_s,
                             const uint4* w, const float* row,
                             const __nv_bfloat16* wx, const float* xs, int k,
                             int n, int warp, int lane) {
  const int kts = k / 16;
  const int strips = n / (NT * 8);
  const int g = lane / 4, q = lane % 4;
  for (int s = warp; s < strips; s += WARPS) {
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    const uint4* wp = w + (size_t)s * (NT / 2) * kts * 32 + lane;
    uint4 b0[NT / 2], b1[NT / 2];
    load_b<NT>(b0, wp, 0, kts);
    if (kts > 1) load_b<NT>(b1, wp, 1, kts);
    for (int kt = 0; kt < kts; kt += 2) {
      mma_kstep<NT>(acc, a_s, kt, b0, lane);
      if (kt + 2 < kts) load_b<NT>(b0, wp, kt + 2, kts);
      if (kt + 1 < kts) {
        mma_kstep<NT>(acc, a_s, kt + 1, b1, lane);
        if (kt + 3 < kts) load_b<NT>(b1, wp, kt + 3, kts);
      }
    }

#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = s * NT * 8 + nt * 8 + q * 2;
      const float r0 = row[col], r1 = row[col + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + h * 8;
          float v0 = acc[mt][nt][h * 2], v1 = acc[mt][nt][h * 2 + 1];
          if (wx != nullptr) {
            v0 += xterm(xs, m, wx, col);
            v1 += xterm(xs, m, wx, col + 1);
          }
          v0 = fmaxf(v0 + r0, 0.f);
          v1 = fmaxf(v1 + r1, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(d_s + m * ACT_STRIDE + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_eval_kernel(const float* __restrict__ xyz, float* __restrict__ out,
                      int n_points, const __nv_bfloat16* __restrict__ w_all,
                      const float* __restrict__ rows,
                      const __nv_bfloat16* __restrict__ wx_all, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act1 = act0 + TILE_M * ACT_STRIDE;
  float* xs = reinterpret_cast<float*>(act1 + TILE_M * ACT_STRIDE);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * TILE_M;

  // xyz tile, rounded to bf16 (kept as f32 values); masked past N
  if (tid < TILE_M * 3) {
    const long long p = m0 + tid / 3;
    const float v = p < n_points ? xyz[m0 * 3 + tid] : 0.f;
    xs[tid] = __bfloat162float(__float2bfloat16_rn(v));
  }
  __syncthreads();

  // layer 0: K = 3 on CUDA cores, + hoisted row, relu, bf16
  {
    const LayerDesc& L = plan.layers[0];
    const float* row = rows + L.row_off;
    const __nv_bfloat16* wx = wx_all + L.x_off;
    const int pairs = L.n / 2;
    for (int e = tid; e < TILE_M * pairs; e += THREADS) {
      const int m = e / pairs, col = (e % pairs) * 2;
      const float v0 = fmaxf(xterm(xs, m, wx, col) + row[col], 0.f);
      const float v1 = fmaxf(xterm(xs, m, wx, col + 1) + row[col + 1], 0.f);
      *reinterpret_cast<__nv_bfloat162*>(act0 + m * ACT_STRIDE + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  __syncthreads();

  __nv_bfloat16* cur = act0;
  __nv_bfloat16* nxt = act1;
  for (int li = 1; li < plan.n_layers - 1; ++li) {
    const LayerDesc& L = plan.layers[li];
    const uint4* w = reinterpret_cast<const uint4*>(w_all + L.w_off);
    const float* row = rows + L.row_off;
    const __nv_bfloat16* wx = L.x_off >= 0 ? wx_all + L.x_off : nullptr;
    if (L.n >= WARPS * 64)
      hidden_layer<8>(cur, nxt, w, row, wx, xs, L.k, L.n, warp, lane);
    else
      hidden_layer<4>(cur, nxt, w, row, wx, xs, L.k, L.n, warp, lane);
    __syncthreads();
    __nv_bfloat16* t = cur;
    cur = nxt;
    nxt = t;
  }

  // final layer: one dot product per point, + bias, optional tanh
  {
    const LayerDesc& L = plan.layers[plan.n_layers - 1];
    const __nv_bfloat16* w = w_all + L.w_off;
    const float bias = rows[L.row_off];
    for (int m = warp; m < TILE_M; m += WARPS) {
      float s = 0.f;
      for (int k = lane * 2; k < L.k; k += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(cur + m * ACT_STRIDE + k));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(w + k));
        s += a.x * b.x + a.y * b.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0 && m0 + m < n_points) {
        float v = s + bias;
        if (plan.use_tanh) v = tanhf(v);
        out[m0 + m] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// meta: n_layers rows of 5 int64 (k, n, w_off, row_off, x_off), host memory.
// Returns the cudaError_t of the launch (0 = success).
int fused_eval_launch(const float* xyz, float* out, long long n_points,
                      const void* w_all, const float* rows, const void* wx_all,
                      const long long* meta, int n_layers, int use_tanh,
                      void* stream) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || n_points > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  Plan plan;
  plan.n_layers = n_layers;
  plan.use_tanh = use_tanh;
  for (int i = 0; i < n_layers; ++i) {
    const long long* r = meta + 5 * i;
    plan.layers[i] = LayerDesc{static_cast<int>(r[0]), static_cast<int>(r[1]),
                               r[2], r[3], r[4]};
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const unsigned blocks =
      static_cast<unsigned>((n_points + TILE_M - 1) / TILE_M);
  fused_eval_kernel<<<blocks, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, out, static_cast<int>(n_points),
      static_cast<const __nv_bfloat16*>(w_all), rows,
      static_cast<const __nv_bfloat16*>(wx_all), plan);
  return static_cast<int>(cudaGetLastError());
}

// Widest padded layer the shared-memory activation buffers hold.
int fused_eval_max_width() { return MAX_WIDTH; }

}  // extern "C"
