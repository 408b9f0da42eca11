// The engine of the two decoder-eval kernels (csrc/fused_eval.cu, one
// latent per launch; csrc/fused_eval_pairs.cu, one latent row per point):
// a weight ring in shared memory fed by bulk copies that a thread-block
// cluster shares, and wgmma products over 64-point tiles whose activations
// stay in shared memory.
//
//  * The weights are packed by the wrapper (ops/cuda_kernels.py) as slabs,
//    one per k16 step of every layer's products in the order the kernel
//    consumes them: for each layer its hidden slabs, then the slabs of its
//    second operand (the kernel's per-point tile: latent rows and xyz, or
//    xyz alone), padded with zero slabs to whole ring stages. A slab holds
//    the layer's n output rows x 16 inputs in wgmma's canonical K-major
//    layout without swizzle (8x8 core matrices of 128 contiguous bytes:
//    conflict-free reads), so a 1-D bulk copy (cp.async.bulk,
//    multicast::cluster) lands it ready for wgmma; no tensor map.
//  * A cluster of CLUSTER CTAs walks the same slab stream in lock step:
//    each CTA's producer thread copies 1/CLUSTER of every slab and
//    multicasts it into the ring of every CTA, so each byte read from L2
//    feeds 64 x CLUSTER points. The ring's stages of STAGE_SLABS 16 KB
//    slots are paced by full (transaction-count) and empty (2 x CLUSTER
//    consumer arrivals) mbarriers.
//  * Two consumer warpgroups each own one half of a layer's output columns
//    (up to 256: m64n256k16, 128 f32 accumulators a thread), both operands
//    from shared memory: per stage one barrier wait, STAGE_SLABS wgmmas (an
//    unrolled loop: no divergent path between them, so ptxas keeps them
//    asynchronous), one commit, and the previous stage released to every
//    CTA of the cluster.
//  * The tile's activations live in one 64 x 512 bf16 buffer in the same
//    core-matrix layout: a layer's product reads all of it before the
//    epilogue overwrites it in place (row, relu, bf16 in one cvt, stored by
//    stmatrix). The last hidden layer's epilogue keeps h in registers and
//    folds the final layer in.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace eval_engine {

using namespace sm90;

constexpr int TILE_M = 64;
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 128;       // and the producer's warpgroup
constexpr int PRODUCER_REGS = 56;              // setmaxnreg: 128 x 56 +
constexpr int CONSUMER_REGS = 224;             //   256 x 224 <= 65,536
constexpr int MAX_WIDTH = 512;
constexpr int MAX_LAYERS = 16;
constexpr int STAGE_SLABS = 2;    // k16 slabs per ring stage (one barrier round)
constexpr int CLUSTER = 2;        // CTAs that share every weight slab
constexpr int SMEM_LIMIT = 232448;             // dynamic shared memory a block may use
constexpr int ACT_BYTES = TILE_M * MAX_WIDTH * 2;
constexpr int SLOT_BYTES = MAX_WIDTH * 16 * 2;  // one k16 slab of the widest layer
constexpr int STAGE_BYTES = STAGE_SLABS * SLOT_BYTES;
// wgmma K-major, no swizzle: byte strides between 8x8 core matrices
constexpr int SLAB_LBO = 128;    // slab: next 8 inputs (k)
constexpr int SLAB_SBO = 256;    // slab: next 8 output rows (n)
constexpr int TILE_LBO = 1024;   // activation / per-point tile: next 8 inputs
constexpr int TILE_SBO = 128;    // activation / per-point tile: next 8 points

struct Layer {
  int k;               // padded hidden input width (0: layer 0; final: its input)
  int n;               // padded output width (1: final layer)
  int k2;              // input width of the per-point tile's product, or 0
  long long w_off;     // bf16 offset of the layer's slabs (final: its weight vector)
  long long row_off;   // f32 offset of the layer's row
};

constexpr int TABLE_BYTES = MAX_LAYERS * static_cast<int>(sizeof(Layer));

__device__ __forceinline__ int padded_slabs(int n) {
  return (n + STAGE_SLABS - 1) / STAGE_SLABS * STAGE_SLABS;
}

// element offset of (point m, input c) in a tile buffer (activations, the
// per-point tile)
__device__ __forceinline__ int tile_off(int m, int c) {
  return ((c >> 3) * 8 + (m >> 3)) * 64 + (m & 7) * 8 + (c & 7);
}

// ---- the ring of weight slots: stage and phase, walked identically by the
// producer and the consumers

struct Ring {
  uint32_t slots, full, empty;   // shared addresses
  int stages, stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The producer thread of a CTA: every slab of every layer, tile after tile
// (the cluster's tiles from base0 on, `stride` apart), its 1/CLUSTER share
// of each multicast into the same slot of every CTA of the cluster.
__device__ __forceinline__ void produce(const Layer* layers, int n_layers,
                                        const __nv_bfloat16* w, uint32_t rank,
                                        long long base0, long long n_tiles,
                                        long long stride, Ring& ring) {
  constexpr uint16_t mask = (1u << CLUSTER) - 1u;
  const char* wb = reinterpret_cast<const char*>(w);
  for (long long base = base0; base < n_tiles; base += stride) {
    for (int li = 0; li < n_layers - 1; ++li) {
      const Layer& L = layers[li];
      const uint32_t bytes = static_cast<uint32_t>(L.n) * 32u;
      const uint32_t share = bytes / CLUSTER;
      const int steps = L.k / 16 + padded_slabs(L.k2 / 16);
      const char* src = wb + L.w_off * 2 + rank * share;
      for (int t0 = 0; t0 < steps; t0 += STAGE_SLABS) {
        const uint32_t full = ring.full + ring.stage * 8;
        mbar_wait(ring.empty + ring.stage * 8, ring.phase ^ 1u);
        mbar_expect_tx(full, bytes * STAGE_SLABS);
#pragma unroll
        for (int i = 0; i < STAGE_SLABS; ++i)
          bulk_copy(ring.slots + ring.stage * STAGE_BYTES + i * SLOT_BYTES +
                        rank * share,
                    src + static_cast<long long>(t0 + i) * bytes, share, full,
                    mask, CLUSTER > 1);
        ring.advance();
      }
    }
  }
}

// One warpgroup's part of a layer's products: acc[64, NW] = act[64, k] @
// W_h[cols, k]^T + pt[64, k2] @ W_2[cols, k2]^T, cols = wg * NW + [0, NW),
// one slab per k16 step, STAGE_SLABS slabs per ring stage (the zero slabs
// that pad the per-point tile's slabs read its first step again); each
// stage goes back to the cluster once its wgmmas have read it.
template <int NW>
__device__ __forceinline__ void layer_products(float (&acc)[NW / 2],
                                               uint32_t act, uint32_t pt,
                                               int kh, int k2, int wg,
                                               uint32_t leader, Ring& ring) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const int hsteps = kh / 16, psteps = k2 / 16;
  const int steps = hsteps + padded_slabs(psteps);
  const uint32_t b_off = static_cast<uint32_t>(wg * (NW / 8) * SLAB_SBO);
  int prev = -1;
  for (int t0 = 0; t0 < steps; t0 += STAGE_SLABS) {
    mbar_wait(ring.full + ring.stage * 8, ring.phase);
    wgmma_fence();
    const uint32_t slab = ring.slots + ring.stage * STAGE_BYTES + b_off;
#pragma unroll
    for (int i = 0; i < STAGE_SLABS; ++i) {
      const int t = t0 + i, tp = t - hsteps;
      const uint32_t a = t < hsteps ? act + t * 2 * TILE_LBO
                                    : pt + (tp < psteps ? tp : 0) * 2 * TILE_LBO;
      Wgmma<NW>::run(acc, desc(a, TILE_LBO, TILE_SBO),
                     desc(slab + i * SLOT_BYTES, SLAB_LBO, SLAB_SBO));
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      for (int c = 0; c < CLUSTER; ++c)
        mbar_arrive_cluster(ring.empty + prev * 8, c, leader);
    }
    prev = ring.stage;
    ring.advance();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
  for (int c = 0; c < CLUSTER; ++c)
    mbar_arrive_cluster(ring.empty + prev * 8, c, leader);
}

// bf16x2 {lo, hi} of relu(lo), relu(hi)
__device__ __forceinline__ uint32_t bf16x2_relu(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
          addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// h[64, cols] = bf16(relu(acc + row)) into the activation tile, in place.
// The accumulator of column block j, row half e is the 8x8 fragment that
// stmatrix stores; one stmatrix.x4 writes blocks j, j+1, both halves. Lane
// l gives the address of row l % 8 of matrix l / 8 (block +l/16, half
// (l/8) % 2); each such row is 16 contiguous bytes of the tile layout.
template <int NW>
__device__ __forceinline__ void layer_epilogue(const float (&acc)[NW / 2],
                                               uint32_t act, const float* row,
                                               int wg, int warp, int lane) {
  const int q = lane % 4, mi = lane / 8;
  const float* b = row + wg * NW + 2 * q;
  const uint32_t base =
      act + 2 * tile_off(16 * warp + 8 * (mi & 1) + lane % 8,
                         wg * NW + 8 * (mi >> 1));
#pragma unroll
  for (int j = 0; j < NW / 8; j += 2) {
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(b + 8 * j));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 8));
    stmatrix_x4(base + j * TILE_LBO,
                bf16x2_relu(acc[4 * j] + b0.x, acc[4 * j + 1] + b0.y),
                bf16x2_relu(acc[4 * j + 2] + b0.x, acc[4 * j + 3] + b0.y),
                bf16x2_relu(acc[4 * j + 4] + b1.x, acc[4 * j + 5] + b1.y),
                bf16x2_relu(acc[4 * j + 6] + b1.x, acc[4 * j + 7] + b1.y));
  }
}

// The last hidden layer with the final layer folded in: h = bf16(relu(acc
// + row)) stays in registers; each thread dots its columns with the final
// weight, the 4 lanes of a row and then the two warpgroups (through `red`,
// [2][64] f32) sum the partials.
template <int NW>
__device__ __forceinline__ void final_fold(const float (&acc)[NW / 2],
                                           const float* row,
                                           const __nv_bfloat16* wf, float* red,
                                           int wg, int warp, int lane) {
  const int g = lane / 4, q = lane % 4;
  const float* b = row + wg * NW + 2 * q;
  const __nv_bfloat16* wq = wf + wg * NW + 2 * q;
  float s0 = 0.f, s1 = 0.f;           // rows 16 warp + g, + 8
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const float2 bj = __ldg(reinterpret_cast<const float2*>(b + 8 * j));
    const uint32_t w2 = __ldg(reinterpret_cast<const unsigned int*>(wq + 8 * j));
    const float w0 = __uint_as_float(w2 << 16);
    const float w1 = __uint_as_float(w2 & 0xffff0000u);
    const uint32_t h0 = bf16x2_relu(acc[4 * j] + bj.x, acc[4 * j + 1] + bj.y);
    const uint32_t h1 =
        bf16x2_relu(acc[4 * j + 2] + bj.x, acc[4 * j + 3] + bj.y);
    s0 += __uint_as_float(h0 << 16) * w0 + __uint_as_float(h0 & 0xffff0000u) * w1;
    s1 += __uint_as_float(h1 << 16) * w0 + __uint_as_float(h1 & 0xffff0000u) * w1;
  }
#pragma unroll
  for (int o = 1; o < 4; o *= 2) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if (q == 0) {
    red[wg * TILE_M + 16 * warp + g] = s0;
    red[wg * TILE_M + 16 * warp + g + 8] = s1;
  }
}

// The clusters of `kernel` (THREADS a CTA, `smem` bytes of dynamic shared
// memory each) that fit on the card at once, after allowing it that much
// shared memory; 0 if none. Returns the cudaError_t of the query.
template <typename Kernel>
int resident_clusters(Kernel kernel, int smem, int* n) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER * 132);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kernel, &cfg));
}

// Launches `kernel` on the clusters that `n_points` needs in 64-point
// tiles, at most `max_clusters`, with `smem` bytes of dynamic shared memory
// a CTA. Returns the cudaError_t of the launch.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), long long n_points,
                    int max_clusters, int smem, void* stream, Args... args) {
  const long long n_tiles = (n_points + TILE_M - 1) / TILE_M;
  const long long want = (n_tiles + CLUSTER - 1) / CLUSTER;
  const int clusters =
      static_cast<int>(want < max_clusters ? want : max_clusters);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace eval_engine
