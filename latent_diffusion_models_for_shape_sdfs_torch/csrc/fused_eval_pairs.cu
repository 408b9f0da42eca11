// Fused SDF-decoder evaluation where every point carries its own latent row.
//
// Replaces the TPU kernel `_build_pairs_kernel` / `make_pallas_apply_pairs`
// in latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py:163,
// the evaluator of the flat batched decode (points of many shapes in one
// work list, ops/grid_eval.py::decode_grid_hierarchical3_batch_flat).
//
// What it computes, for a tile of TILE_M points (xyz [N,3] f32, z rows
// [N,Lp] bf16, rows >= N masked):
//   layer 0      : h = bf16(relu(z @ W_z^T + bf16(xyz) . w_x + b))
//   hidden layer : h = bf16(relu(h @ W_h^T [+ z @ W_z^T + bf16(xyz) . w_x] + b))
//   final layer  : sdf = h . w + b, optional tanh
// The latent products of layer 0 and of the skip (`latent_in`) layers run
// per tile on the tensor cores, since no two points need share a latent.
// Products are bf16 x bf16 with f32 accumulation (mma.sync m16n8k16);
// every hidden activation is re-rounded to bf16: the arithmetic of
// ops/fused_decoder.py::fast_apply in bf16 over z rows (the plain version
// this kernel is held against), summed in another order (the hidden and
// latent products share one accumulator; then the xyz term, then the bias).
//
// Bound on this card: the canonical 8x512 plan with L = 256 does
// 1,835,520 multiply-adds per point (kernel #1's 1,573,376 plus the two
// 256x512 latent products) against 528 bytes of input/output per point
// (a bf16 z row, xyz, sdf), so it is compute-bound: 3.67 MFLOP per point,
// 3.89 ms per 2^20 points at 989 TFLOP/s bf16.
//
// Design (kernel #1's, csrc/fused_eval.cu, plus a per-tile latent operand):
//  * The tile's activations live in two ping-pong buffers in dynamic shared
//    memory (2 x 64 x 520 bf16), rows padded by 8 elements so ldmatrix and
//    the epilogue's stores are free of bank conflicts. Nothing between
//    layers touches device memory.
//  * The tile's 64 z rows are copied into shared memory once, with 16-byte
//    loads, into a third buffer whose row stride is Lp + 8 elements (an odd
//    multiple of 16 bytes: conflict-free ldmatrix). Layer 0 and every skip
//    layer read their A fragments for z @ W_z^T from it, through the same
//    mma path as the hidden product. Shared memory at L = 256:
//    2*64*520*2 + 64*3*4 + 64*264*2 = 167,680 B.
//  * Weights are streamed from L2, not kept in shared memory: each hidden
//    weight and each W_z is stored by the wrapper in mma fragment order
//    [n/16][k/16][32 lanes][8], so a lane reads the B fragments of two n8
//    tiles with one coalesced 16-byte load, prefetched two k-steps ahead.
//  * Each layer's row is its f32 bias only (nothing is hoisted per shape),
//    uploaded once by the wrapper. Widths are padded to multiples of 64 and
//    L to a multiple of 16 with zeros, which contribute nothing.
//
// What bounds it today: as kernel #1, the weights (now with the W_z slices)
// are re-read from L2 for every 64-point tile, so L2 bandwidth, not the
// tensor cores, is the expected limit. Larger tiles (wgmma, clusters
// sharing weights through TMA multicast) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 64;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_WIDTH = 512;
constexpr int MAX_LATENT = 512;
constexpr int ACT_STRIDE = MAX_WIDTH + 8;  // bf16 elements per smem row
constexpr int MAX_LAYERS = 16;
constexpr size_t BASE_SMEM =
    2 * TILE_M * ACT_STRIDE * sizeof(__nv_bfloat16) + TILE_M * 3 * sizeof(float);

size_t smem_bytes(int lz) {
  return BASE_SMEM + static_cast<size_t>(TILE_M) * (lz + 8) * sizeof(__nv_bfloat16);
}

struct LayerDesc {
  int k;              // padded input width of the hidden product (0: layer 0)
  int n;              // padded output width (1: final layer)
  long long w_off;    // bf16 offset of the hidden weights in w_all
  long long wz_off;   // bf16 offset of W_z [n, Lp] in w_all, or -1
  long long row_off;  // f32 offset of the bias row in rows
  long long x_off;    // bf16 offset of w_x [n,3] in wx_all, or -1
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

// B fragments of NT n8 tiles (NT/2 tile pairs) for k-step kt; layout
// [n/16 pairs][k/16 steps][32 lanes] of uint4 (the wrapper's fragment_order).
template <int NT>
__device__ __forceinline__ void load_b(uint4 (&b)[NT / 2], const uint4* wp,
                                       int kt, int kts) {
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) b[p] = __ldg(wp + ((size_t)p * kts + kt) * 32);
}

template <int NT>
__device__ __forceinline__ void mma_kstep(float (&acc)[4][NT][4],
                                          const __nv_bfloat16* a_s, int stride,
                                          int kt, const uint4 (&b)[NT / 2],
                                          int lane) {
  const __nv_bfloat16* base =
      a_s + (lane % 16) * stride + kt * 16 + (lane / 16) * 8;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    uint32_t a[4];
    ldmatrix_x4(a, base + mt * 16 * stride);
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

// acc[64, NT*8 strip s] += a_s[64, k] @ W[strip, k]^T, B prefetched two
// k-steps ahead. `w` is the layer's weight in fragment order.
template <int NT>
__device__ __forceinline__ void gemm_strip(float (&acc)[4][NT][4],
                                           const __nv_bfloat16* a_s, int stride,
                                           const uint4* w, int k, int s,
                                           int lane) {
  const int kts = k / 16;
  const uint4* wp = w + (size_t)s * (NT / 2) * kts * 32 + lane;
  uint4 b0[NT / 2], b1[NT / 2];
  load_b<NT>(b0, wp, 0, kts);
  if (kts > 1) load_b<NT>(b1, wp, 1, kts);
  for (int kt = 0; kt < kts; kt += 2) {
    mma_kstep<NT>(acc, a_s, stride, kt, b0, lane);
    if (kt + 2 < kts) load_b<NT>(b0, wp, kt + 2, kts);
    if (kt + 1 < kts) {
      mma_kstep<NT>(acc, a_s, stride, kt + 1, b1, lane);
      if (kt + 3 < kts) load_b<NT>(b1, wp, kt + 3, kts);
    }
  }
}

// One layer: d_s[64, n] = bf16(relu(a_s @ W^T [+ z_s @ Wz^T] [+ xterm] + row)).
// a_s may be null (layer 0: latent and xyz terms only). Warps walk strips
// of NT*8 output columns.
template <int NT>
__device__ void dense_layer(const __nv_bfloat16* a_s, int k, const uint4* w,
                            const __nv_bfloat16* z_s, int lz, const uint4* wz,
                            __nv_bfloat16* d_s, const float* row,
                            const __nv_bfloat16* wx, const float* xs, int n,
                            int warp, int lane) {
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

    if (a_s != nullptr) gemm_strip<NT>(acc, a_s, ACT_STRIDE, w, k, s, lane);
    if (z_s != nullptr) gemm_strip<NT>(acc, z_s, lz + 8, wz, lz, s, lane);

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

template <int NT>
__device__ __forceinline__ void run_layer(const LayerDesc& L,
                                          const __nv_bfloat16* cur,
                                          __nv_bfloat16* nxt,
                                          const __nv_bfloat16* z_s, int lz,
                                          const __nv_bfloat16* w_all,
                                          const float* rows,
                                          const __nv_bfloat16* wx_all,
                                          const float* xs, int warp, int lane) {
  const bool has_z = L.wz_off >= 0;
  dense_layer<NT>(L.k > 0 ? cur : nullptr, L.k,
                  reinterpret_cast<const uint4*>(w_all + L.w_off),
                  has_z ? z_s : nullptr, lz,
                  reinterpret_cast<const uint4*>(w_all + (has_z ? L.wz_off : 0)),
                  nxt, rows + L.row_off, L.x_off >= 0 ? wx_all + L.x_off : nullptr,
                  xs, L.n, warp, lane);
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_eval_pairs_kernel(const float* __restrict__ xyz,
                            const __nv_bfloat16* __restrict__ z, int lz,
                            float* __restrict__ out, int n_points,
                            const __nv_bfloat16* __restrict__ w_all,
                            const float* __restrict__ rows,
                            const __nv_bfloat16* __restrict__ wx_all, Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act0 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* act1 = act0 + TILE_M * ACT_STRIDE;
  float* xs = reinterpret_cast<float*>(act1 + TILE_M * ACT_STRIDE);
  __nv_bfloat16* z_s = reinterpret_cast<__nv_bfloat16*>(xs + TILE_M * 3);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * TILE_M;

  // xyz tile, rounded to bf16 (kept as f32 values); masked past N
  if (tid < TILE_M * 3) {
    const long long p = m0 + tid / 3;
    const float v = p < n_points ? xyz[m0 * 3 + tid] : 0.f;
    xs[tid] = __bfloat162float(__float2bfloat16_rn(v));
  }
  // the tile's z rows, 16 bytes per load; zeros past N
  {
    const int vecs = lz / 8;
    const uint4* zg = reinterpret_cast<const uint4*>(z);
    for (int e = tid; e < TILE_M * vecs; e += THREADS) {
      const int m = e / vecs, c = e % vecs;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < n_points) v = __ldg(zg + (m0 + m) * vecs + c);
      *reinterpret_cast<uint4*>(z_s + m * (lz + 8) + c * 8) = v;
    }
  }
  __syncthreads();

  __nv_bfloat16* cur = act1;
  __nv_bfloat16* nxt = act0;
  for (int li = 0; li < plan.n_layers - 1; ++li) {
    const LayerDesc& L = plan.layers[li];
    if (L.n >= WARPS * 64)
      run_layer<8>(L, cur, nxt, z_s, lz, w_all, rows, wx_all, xs, warp, lane);
    else
      run_layer<4>(L, cur, nxt, z_s, lz, w_all, rows, wx_all, xs, warp, lane);
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

// z: [n_points, lz] bf16, lz a multiple of 16, 16-byte aligned.
// meta: n_layers rows of 6 int64 (k, n, w_off, wz_off, row_off, x_off),
// host memory. Returns the cudaError_t of the launch (0 = success).
int fused_eval_pairs_launch(const float* xyz, const void* z, int lz,
                            float* out, long long n_points, const void* w_all,
                            const float* rows, const void* wx_all,
                            const long long* meta, int n_layers, int use_tanh,
                            void* stream) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || n_points > 0x7fffffffLL ||
      lz < 16 || lz > MAX_LATENT || lz % 16 != 0 ||
      reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  Plan plan;
  plan.n_layers = n_layers;
  plan.use_tanh = use_tanh;
  for (int i = 0; i < n_layers; ++i) {
    const long long* r = meta + 6 * i;
    plan.layers[i] = LayerDesc{static_cast<int>(r[0]), static_cast<int>(r[1]),
                               r[2], r[3], r[4], r[5]};
  }
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_eval_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(MAX_LATENT)));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const unsigned blocks =
      static_cast<unsigned>((n_points + TILE_M - 1) / TILE_M);
  fused_eval_pairs_kernel<<<blocks, THREADS, smem_bytes(lz),
                            static_cast<cudaStream_t>(stream)>>>(
      xyz, static_cast<const __nv_bfloat16*>(z), lz, out,
      static_cast<int>(n_points), static_cast<const __nv_bfloat16*>(w_all),
      rows, static_cast<const __nv_bfloat16*>(wx_all), plan);
  return static_cast<int>(cudaGetLastError());
}

// Widest padded layer and latent the shared-memory buffers hold.
int fused_eval_pairs_max_width() { return MAX_WIDTH; }
int fused_eval_pairs_max_latent() { return MAX_LATENT; }

}  // extern "C"
