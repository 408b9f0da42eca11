// Fused training pass of the SDF decoder: forward, clamped-L1 loss and
// the full backward with respect to the folded weights and the latents.
//
// Replaces the TPU kernel `_build_train_kernel` (via `fused_train_loss_grads`
// and `make_pallas_ad_loss_grads`) in
// latent_diffusion_models_for_shape_sdfs_tpu/ops/fused_train.py.
//
// What it computes, for S scenes x P points (N = S*P), from folded bf16
// weights (torch layout [out, in], widths zero-padded by the wrapper to
// multiples of 128), latents z [S, L] f32, xyz [N, 3] bf16 and sdf [N] f32:
//   forward : h_0 = drop(relu(b + bf16(z_s) W_z^T + xyz W_x^T)),
//             h_i = drop(relu(h_{i-1} W_h^T + b [+ z and xyz terms at the
//             skip layer])), pred = h_last . w + b; each h rounded to bf16;
//   loss    : sum |clamp(pred) - clamp(sdf)|, dpred = sign(diff)/n inside
//             the clamp band, rounded to bf16;
//   backward: g_{i-1} = bf16(where(h_{i-1} > 0, (g_i W_h) * scale, 0))
//             (the relu+dropout mask recovered from the stored activation,
//             as the TPU kernel does), dW_h = g^T h (f32), db = sum g,
//             and at layer 0 and the skip layer gsum_s = sum of g over the
//             scene, dW_z = gsum^T z, dW_x = g^T xyz, dz_s += bf16(gsum_s) W_z.
// Dropout bits: Philox4x32-10 of (row = point index, col) keyed by
// seed + 7919 * layer (philox.cuh), the same mask as csrc/relu_dropout.cu.
// The TPU kernel rounds each 256-point tile's gsum to bf16 before the dz
// product; this one rounds the whole scene's gsum once.
//
// Bound on this card: operations. 4,717,056 MAC per point for the 8x512
// decoder (forward 1,573,376, dgrad 1,570,304, wgrad 1,573,376), so one
// 64 x 16,384-point step is 9.89 TFLOP: 10.0 ms at 989 TFLOP/s bf16.
//
// Design (simple first; a persistent fused kernel with wgmma and TMA is
// later work). The TPU keeps a tile's nine layers of activations in VMEM
// (2.1 MB) and accumulates dW in VMEM over a sequential grid; an SM has
// 227 KB and blocks run concurrently. So the pass is a sequence of
// launches:
//   * one bf16 GEMM kernel (128x128x32 block tile, 8 warps of 64x32,
//     mma.sync m16n8k16 with f32 accumulation, ldmatrix fragments, a
//     two-stage cp.async pipeline) with three operand layouts and
//     epilogues: forward (bias row per scene, skip-layer xyz term, relu,
//     Philox dropout, bf16 store of h to device memory), dgrad (mask from
//     the stored h, scale, bf16 store of g) and wgrad (split-K over the
//     points into f32 partials);
//   * small CUDA-core kernels: the per-scene latent rows, layer 0 (K = 3),
//     the final layer with the loss and its dgrad/wgrad, per-scene column
//     sums of g, the latent gradients;
//   * a fixed-order reduction of every set of partials. No float atomics
//     anywhere, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void cp_async16(bf16* smem, const bf16* gmem) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(addr),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------------ GEMM
//
// C[M, N] = sum_k A[m, k] B[k, n] over a k range, bf16 x bf16 -> f32.
// A is given either K-contiguous ([M][lda], AT = false) or M-contiguous
// ([K][lda], AT = true); B either K-contiguous ([N][ldb], BT = false) or
// N-contiguous ([K][ldb], BT = true). In shared memory a K-contiguous tile
// is [128][BK + 8] and an M/N-contiguous one [BK][128 + 8]; the 8-element
// row padding makes every ldmatrix phase conflict-free.
//   forward: A = h_{i-1} [points][in] (AT=0), B = W [out][in] (BT=0)
//   dgrad  : A = g [points][out] (AT=0),     B = W [out][in] (BT=1)
//   wgrad  : A = g [points][out] (AT=1),     B = h_{i-1} [points][in] (BT=1)

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int GEMM_THREADS = 256;
constexpr int STRIDE_K = BK + 8;    // K-contiguous tile row (elements)
constexpr int STRIDE_MN = BM + 8;   // M/N-contiguous tile row (elements)
constexpr int TILE_K = BM * STRIDE_K;
constexpr int TILE_MN = BK * STRIDE_MN;

enum Epilogue { EPI_FWD = 0, EPI_DGRAD = 1, EPI_WGRAD = 2 };

struct GemmArgs {
  const bf16* a;
  long long lda;
  const bf16* b;
  long long ldb;
  int m, n;
  long long k_split;          // reduction length per blockIdx.z
  // forward epilogue
  const float* rows;          // bias row: rows[(row / p) * rows_stride + col]
  long long rows_stride;      // 0: one row shared by all points
  long long p;                // points per scene
  const bf16* xyz;            // [points][3] bf16 or null (skip layer only)
  const bf16* wx;             // [n][3] bf16
  uint32_t key, threshold;
  int drop;
  float scale;                // 1/(1-rate) (forward, dgrad) or 1
  // dgrad epilogue
  const bf16* hprev;          // [points][ldh]
  long long ldh;
  // outputs
  bf16* out;                  // forward, dgrad: [points][ldo]
  long long ldo;
  float* part;                // wgrad: [gridDim.z][m][n]
};

// Copies one BK-deep slice of an operand tile into shared memory.
template <bool T>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long long ld,
                                          int mn0, long long k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * GEMM_THREADS;
    if (!T) {  // [128 rows (m or n)][BK] <- g[(mn0 + row) * ld + k0 + col]
      const int row = c >> 2, col = (c & 3) * 8;
      cp_async16(s + row * STRIDE_K + col, g + (mn0 + row) * ld + k0 + col);
    } else {   // [BK rows (k)][128] <- g[(k0 + row) * ld + mn0 + col]
      const int row = c >> 4, col = (c & 15) * 8;
      cp_async16(s + row * STRIDE_MN + col, g + (k0 + row) * ld + mn0 + col);
    }
  }
}

template <bool AT, bool BT, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS)
    gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) bf16 as_buf[2][AT ? TILE_MN : TILE_K];
  __shared__ __align__(16) bf16 bs_buf[2][BT ? TILE_MN : TILE_K];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm0 = (warp >> 2) * 64, wn0 = (warp & 3) * 32;
  const long long kbeg = (long long)blockIdx.z * p.k_split;
  const int kt_n = static_cast<int>(p.k_split / BK);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load_tile<AT>(as_buf[0], p.a, p.lda, m0, kbeg, tid);
  load_tile<BT>(bs_buf[0], p.b, p.ldb, n0, kbeg, tid);
  cp_async_commit();

  const int j8 = lane >> 3, r8 = lane & 7;
  for (int kt = 0; kt < kt_n; ++kt) {
    if (kt + 1 < kt_n) {
      const long long k1 = kbeg + (long long)(kt + 1) * BK;
      load_tile<AT>(as_buf[(kt + 1) & 1], p.a, p.lda, m0, k1, tid);
      load_tile<BT>(bs_buf[(kt + 1) & 1], p.b, p.ldb, n0, k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* as = as_buf[kt & 1];
    const bf16* bs = bs_buf[kt & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int mb = wm0 + mt * 16;
        if (!AT)
          ldmatrix_x4(a[mt], as + (mb + (lane & 15)) * STRIDE_K + kk +
                                 (lane >> 4) * 8);
        else
          ldmatrix_x4_trans(a[mt], as + (kk + r8 + ((j8 >> 1) << 3)) * STRIDE_MN +
                                       mb + ((j8 & 1) << 3));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int nb = wn0 + np * 16;
        if (!BT)
          ldmatrix_x4(b[np], bs + (nb + r8 + ((j8 >> 1) << 3)) * STRIDE_K + kk +
                                 ((j8 & 1) << 3));
        else
          ldmatrix_x4_trans(b[np], bs + (kk + r8 + ((j8 & 1) << 3)) * STRIDE_MN +
                                       nb + ((j8 >> 1) << 3));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2],
                   b[nt >> 1][(nt & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // epilogue: lane (g, q) holds rows g and g + 8, columns 2q and 2q + 1
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm0 + mt * 16 + gq + h * 8;
      float x0 = 0.f, x1 = 0.f, x2 = 0.f;
      const float* rw = nullptr;
      if (EPI == EPI_FWD) {
        rw = p.rows + (row / p.p) * p.rows_stride;
        if (p.xyz != nullptr) {
          x0 = __bfloat162float(p.xyz[row * 3]);
          x1 = __bfloat162float(p.xyz[row * 3 + 1]);
          x2 = __bfloat162float(p.xyz[row * 3 + 2]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn0 + nt * 8 + q * 2;
        float v0 = acc[mt][nt][h * 2], v1 = acc[mt][nt][h * 2 + 1];
        if (EPI == EPI_FWD) {
          v0 += rw[col];
          v1 += rw[col + 1];
          if (p.xyz != nullptr) {
            const bf16* w0 = p.wx + col * 3;
            v0 += x0 * __bfloat162float(w0[0]) + x1 * __bfloat162float(w0[1]) +
                  x2 * __bfloat162float(w0[2]);
            v1 += x0 * __bfloat162float(w0[3]) + x1 * __bfloat162float(w0[4]) +
                  x2 * __bfloat162float(w0[5]);
          }
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
          if (p.drop) {
            const uint4 bits =
                philox::dropout_bits(row, static_cast<uint32_t>(col >> 2), p.key);
            const int j = col & 3;
            v0 = philox::word(bits, j) >= p.threshold ? v0 * p.scale : 0.f;
            v1 = philox::word(bits, j + 1) >= p.threshold ? v1 * p.scale : 0.f;
          }
          *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.ldo + col) =
              __floats2bfloat162_rn(v0, v1);
        } else if (EPI == EPI_DGRAD) {
          const float2 hp = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.hprev + row * p.ldh + col));
          v0 = hp.x > 0.f ? v0 * p.scale : 0.f;
          v1 = hp.y > 0.f ? v1 * p.scale : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(p.out + row * p.ldo + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(
              p.part + ((long long)blockIdx.z * p.m + row) * p.n + col) =
              make_float2(v0, v1);
        }
      }
    }
  }
}

template <bool AT, bool BT, int EPI>
int launch_gemm(const GemmArgs& p, long long k_total, cudaStream_t stream) {
  if (p.m % BM || p.n % BN || p.k_split % BK || p.k_split <= 0 ||
      k_total % p.k_split || p.lda % 8 || p.ldb % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.m / BM, p.n / BN, static_cast<unsigned>(k_total / p.k_split));
  gemm_kernel<AT, BT, EPI><<<grid, GEMM_THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------- small kernels

constexpr int SMALL_THREADS = 256;

unsigned small_blocks(long long n) {
  return static_cast<unsigned>((n + SMALL_THREADS - 1) / SMALL_THREADS);
}

// rows[s][n] = b[n] + sum_k bf16(z[s][k]) w_z[n][k]
__global__ void scene_rows_kernel(const float* __restrict__ z,
                                  const bf16* __restrict__ wz,
                                  const float* __restrict__ b,
                                  float* __restrict__ rows, int s_count, int l,
                                  int width) {
  const long long t = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= (long long)s_count * width) return;
  const int s = static_cast<int>(t / width), n = static_cast<int>(t % width);
  float acc = 0.f;
  for (int k = 0; k < l; ++k)
    acc += bf16_round(z[s * l + k]) * __bfloat162float(wz[(long long)n * l + k]);
  rows[t] = b[n] + acc;
}

// Layer 0 (K = 3 on CUDA cores): h[m][4g..4g+3] from the scene's row, xyz,
// relu and dropout; one Philox call per 4 columns.
__global__ void layer0_kernel(const bf16* __restrict__ xyz,
                              const float* __restrict__ rows,
                              const bf16* __restrict__ wx, bf16* __restrict__ h,
                              long long n_points, long long p, int width,
                              uint32_t key, uint32_t threshold, float scale,
                              int drop) {
  const int groups = width / 4;
  const long long t = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= n_points * groups) return;
  const long long m = t / groups;
  const int gi = static_cast<int>(t % groups);
  const float* rw = rows + (m / p) * width;
  const float x0 = __bfloat162float(xyz[m * 3]);
  const float x1 = __bfloat162float(xyz[m * 3 + 1]);
  const float x2 = __bfloat162float(xyz[m * 3 + 2]);
  uint4 bits = make_uint4(0u, 0u, 0u, 0u);
  if (drop) bits = philox::dropout_bits(m, static_cast<uint32_t>(gi), key);
  __align__(8) bf16 o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = gi * 4 + j;
    float v = rw[col] + x0 * __bfloat162float(wx[col * 3]) +
              x1 * __bfloat162float(wx[col * 3 + 1]) +
              x2 * __bfloat162float(wx[col * 3 + 2]);
    v = fmaxf(v, 0.f);
    if (drop) v = philox::word(bits, j) >= threshold ? v * scale : 0.f;
    o[j] = __float2bfloat16_rn(v);
  }
  *reinterpret_cast<uint2*>(h + m * width + gi * 4) =
      *reinterpret_cast<const uint2*>(o);
}

// Final layer, loss, dpred, and the final layer's backward, for a tile of
// FINAL_TILE points: pred = h . w + b; loss_part = sum |diff|; g_last =
// bf16(dpred); g_out = bf16(where(h > 0, g_last * w * scale, 0));
// dw_part = sum_t g_last h; db_part = sum_t g_last.
constexpr int FINAL_TILE = 64;

__global__ void __launch_bounds__(SMALL_THREADS)
    final_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ sdf,
                 bf16* __restrict__ g_out, float* __restrict__ loss_part,
                 float* __restrict__ dw_part, float* __restrict__ db_part,
                 int k_width, float clamp, float inv_n, float scale) {
  __shared__ float gs[FINAL_TILE];
  __shared__ float red[SMALL_THREADS / 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * FINAL_TILE;
  float lsum = 0.f;
  for (int mi = warp; mi < FINAL_TILE; mi += SMALL_THREADS / 32) {
    const bf16* hr = h + (m0 + mi) * k_width;
    float s = 0.f;
    for (int k = lane * 2; k < k_width; k += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hr + k));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
      s += a.x * c.x + a.y * c.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float pred = s + b[0];
      const float diff = fminf(fmaxf(pred, -clamp), clamp) -
                         fminf(fmaxf(sdf[m0 + mi], -clamp), clamp);
      lsum += fabsf(diff);
      const float sgn = diff > 0.f ? 1.f : (diff < 0.f ? -1.f : 0.f);
      gs[mi] = bf16_round(fabsf(pred) < clamp ? sgn * inv_n : 0.f);
    }
  }
  if (lane == 0) red[warp] = lsum;
  __syncthreads();
  if (tid == 0) {
    float l = 0.f, d = 0.f;
    for (int i = 0; i < SMALL_THREADS / 32; ++i) l += red[i];
    for (int i = 0; i < FINAL_TILE; ++i) d += gs[i];
    loss_part[blockIdx.x] = l;
    db_part[blockIdx.x] = d;
  }
  for (int k = tid * 2; k < k_width; k += SMALL_THREADS * 2) {
    const float2 wk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
    float d0 = 0.f, d1 = 0.f;
    for (int mi = 0; mi < FINAL_TILE; ++mi) {
      const long long off = (m0 + mi) * k_width + k;
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + off));
      const float gv = gs[mi];
      d0 += gv * hv.x;
      d1 += gv * hv.y;
      *reinterpret_cast<__nv_bfloat162*>(g_out + off) = __floats2bfloat162_rn(
          hv.x > 0.f ? gv * wk.x * scale : 0.f, hv.y > 0.f ? gv * wk.y * scale : 0.f);
    }
    dw_part[(long long)blockIdx.x * k_width + k] = d0;
    dw_part[(long long)blockIdx.x * k_width + k + 1] = d1;
  }
}

// Column sums of g over a chunk of COLSUM_TILE points (inside one scene):
// part[c][0][n] = sum g, part[c][1 + j][n] = sum bf16(xyz_j) g.
constexpr int COLSUM_TILE = 256;

__global__ void __launch_bounds__(SMALL_THREADS)
    colsum_kernel(const bf16* __restrict__ g, const bf16* __restrict__ xyz,
                  float* __restrict__ part, int width) {
  __shared__ float xs[COLSUM_TILE * 3];
  const long long m0 = (long long)blockIdx.x * COLSUM_TILE;
  for (int i = threadIdx.x; i < COLSUM_TILE * 3; i += SMALL_THREADS)
    xs[i] = __bfloat162float(xyz[m0 * 3 + i]);
  __syncthreads();
  float* out = part + (long long)blockIdx.x * 4 * width;
  for (int k = threadIdx.x * 2; k < width; k += SMALL_THREADS * 2) {
    float s[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int t = 0; t < COLSUM_TILE; ++t) {
      const float2 gv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(g + (m0 + t) * width + k));
      s[0][0] += gv.x;
      s[0][1] += gv.y;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        s[1 + j][0] += xs[t * 3 + j] * gv.x;
        s[1 + j][1] += xs[t * 3 + j] * gv.y;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[j * width + k] = s[j][0];
      out[j * width + k + 1] = s[j][1];
    }
  }
}

// out[o][e] = sum_{c < n_sum} part[(o * n_sum + c) * stride + e], in order.
__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ out, int n_out, int n_sum,
                              long long len, long long stride) {
  const long long t = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= (long long)n_out * len) return;
  const long long o = t / len, e = t % len;
  const float* src = part + o * n_sum * stride + e;
  float s = 0.f;
  for (int c = 0; c < n_sum; ++c) s += src[c * stride];
  out[t] = s;
}

// dz[s][k] (+)= sum_n bf16(gsum[s][n]) w_z[n][k]
__global__ void dz_kernel(const float* __restrict__ gsum,
                          const bf16* __restrict__ wz, float* __restrict__ dz,
                          int s_count, int l, int width, int accumulate) {
  const long long t = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= (long long)s_count * l) return;
  const int s = static_cast<int>(t / l), k = static_cast<int>(t % l);
  float acc = 0.f;
  for (int n = 0; n < width; ++n)
    acc += bf16_round(gsum[(long long)s * width + n]) *
           __bfloat162float(wz[(long long)n * l + k]);
  dz[t] = accumulate ? dz[t] + acc : acc;
}

// dwz[n][k] = sum_s gsum[s][n] z[s][k]   (z in f32, as the TPU kernel)
__global__ void dwz_kernel(const float* __restrict__ gsum,
                           const float* __restrict__ z, float* __restrict__ dwz,
                           int s_count, int l, int width) {
  const long long t = (long long)blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (t >= (long long)width * l) return;
  const int n = static_cast<int>(t / l), k = static_cast<int>(t % l);
  float acc = 0.f;
  for (int s = 0; s < s_count; ++s)
    acc += gsum[(long long)s * width + n] * z[(long long)s * l + k];
  dwz[t] = acc;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// Every function launches on `stream` and returns the cudaError_t of its
// launch (0 = success); pointers are device pointers, bf16 as void*.

// h_out[M][ldo] = drop(relu(h[M][K] W[N][K]^T + rows (+ xyz term))).
int ft_gemm_fwd(const void* h, long long ldh, const void* w, long long ldw,
                int m, int n, long long k, const float* rows,
                long long rows_stride, long long p, const void* xyz,
                const void* wx, unsigned key, unsigned threshold, float scale,
                int drop, void* out, long long ldo, void* stream) {
  GemmArgs a{};
  a.a = static_cast<const bf16*>(h);
  a.lda = ldh;
  a.b = static_cast<const bf16*>(w);
  a.ldb = ldw;
  a.m = m;
  a.n = n;
  a.k_split = k;
  a.rows = rows;
  a.rows_stride = rows_stride;
  a.p = p;
  a.xyz = static_cast<const bf16*>(xyz);
  a.wx = static_cast<const bf16*>(wx);
  a.key = key;
  a.threshold = threshold;
  a.scale = scale;
  a.drop = drop;
  a.out = static_cast<bf16*>(out);
  a.ldo = ldo;
  if (ldo % 2 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm<false, false, EPI_FWD>(a, k, static_cast<cudaStream_t>(stream));
}

// g_prev[M][ldo] = bf16(where(hprev > 0, (g[M][K] W[K][N]) * scale, 0)).
int ft_gemm_dgrad(const void* g, long long ldg, const void* w, long long ldw,
                  int m, int n, long long k, const void* hprev, long long ldh,
                  float scale, void* out, long long ldo, void* stream) {
  GemmArgs a{};
  a.a = static_cast<const bf16*>(g);
  a.lda = ldg;
  a.b = static_cast<const bf16*>(w);
  a.ldb = ldw;
  a.m = m;
  a.n = n;
  a.k_split = k;
  a.hprev = static_cast<const bf16*>(hprev);
  a.ldh = ldh;
  a.scale = scale;
  a.out = static_cast<bf16*>(out);
  a.ldo = ldo;
  if (ldo % 2 || ldh % 2) return static_cast<int>(cudaErrorInvalidValue);
  return launch_gemm<false, true, EPI_DGRAD>(a, k, static_cast<cudaStream_t>(stream));
}

// part[K / k_split][M][N] = per-chunk sums of g[K][M]^T h[K][N].
int ft_gemm_wgrad(const void* g, long long ldg, const void* h, long long ldh,
                  int m, int n, long long k, long long k_split, float* part,
                  void* stream) {
  GemmArgs a{};
  a.a = static_cast<const bf16*>(g);
  a.lda = ldg;
  a.b = static_cast<const bf16*>(h);
  a.ldb = ldh;
  a.m = m;
  a.n = n;
  a.k_split = k_split;
  a.part = part;
  return launch_gemm<true, true, EPI_WGRAD>(a, k, static_cast<cudaStream_t>(stream));
}

int ft_scene_rows(const float* z, const void* wz, const float* b, float* rows,
                  int s_count, int l, int width, void* stream) {
  const long long n = (long long)s_count * width;
  if (n == 0) return 0;
  scene_rows_kernel<<<small_blocks(n), SMALL_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      z, static_cast<const bf16*>(wz), b, rows, s_count, l, width);
  return last_error();
}

int ft_layer0(const void* xyz, const float* rows, const void* wx, void* h,
              long long n_points, long long p, int width, unsigned key,
              unsigned threshold, float scale, int drop, void* stream) {
  if (width % 4 || p <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = n_points * (width / 4);
  if (n == 0) return 0;
  layer0_kernel<<<small_blocks(n), SMALL_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xyz), rows, static_cast<const bf16*>(wx),
      static_cast<bf16*>(h), n_points, p, width, key, threshold, scale, drop);
  return last_error();
}

int ft_final(const void* h, const void* w, const float* b, const float* sdf,
             void* g_out, float* loss_part, float* dw_part, float* db_part,
             long long n_points, int k_width, float clamp, float inv_n,
             float scale, void* stream) {
  if (n_points % FINAL_TILE || k_width % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  final_kernel<<<static_cast<unsigned>(n_points / FINAL_TILE), SMALL_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, sdf,
      static_cast<bf16*>(g_out), loss_part, dw_part, db_part, k_width, clamp,
      inv_n, scale);
  return last_error();
}

int ft_colsum(const void* g, const void* xyz, float* part, long long n_points,
              int width, void* stream) {
  if (n_points % COLSUM_TILE || width % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  colsum_kernel<<<static_cast<unsigned>(n_points / COLSUM_TILE), SMALL_THREADS,
                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(xyz), part, width);
  return last_error();
}

int ft_reduce(const float* part, float* out, int n_out, int n_sum,
              long long len, long long stride, void* stream) {
  const long long n = (long long)n_out * len;
  if (n == 0) return 0;
  reduce_kernel<<<small_blocks(n), SMALL_THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(part, out, n_out, n_sum,
                                                       len, stride);
  return last_error();
}

int ft_dz(const float* gsum, const void* wz, float* dz, int s_count, int l,
          int width, int accumulate, void* stream) {
  const long long n = (long long)s_count * l;
  if (n == 0) return 0;
  dz_kernel<<<small_blocks(n), SMALL_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(
      gsum, static_cast<const bf16*>(wz), dz, s_count, l, width, accumulate);
  return last_error();
}

int ft_dwz(const float* gsum, const float* z, float* dwz, int s_count, int l,
           int width, void* stream) {
  const long long n = (long long)width * l;
  if (n == 0) return 0;
  dwz_kernel<<<small_blocks(n), SMALL_THREADS, 0,
               static_cast<cudaStream_t>(stream)>>>(gsum, z, dwz, s_count, l,
                                                    width);
  return last_error();
}

// Tile constants the wrapper must respect: {BM, BN, BK, FINAL_TILE, COLSUM_TILE}.
void ft_constants(int* out) {
  out[0] = BM;
  out[1] = BN;
  out[2] = BK;
  out[3] = FINAL_TILE;
  out[4] = COLSUM_TILE;
}

}  // extern "C"
