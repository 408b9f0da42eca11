// Fused SDF-decoder evaluation where every point carries its own latent row,
// designed for Hopper (sm_90a): wgmma, a shared-memory weight ring fed by
// bulk copies that a thread-block cluster shares, persistent CTAs, and
// latent rows read by index.
//
// Replaces the TPU kernel `_build_pairs_kernel` / `make_pallas_apply_pairs`
// in latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py:163,
// the evaluator of the flat batched decode (points of many shapes in one
// work list, ops/grid_eval.py::decode_grid_hierarchical3_batch_flat).
//
// What it computes, for points p < N (xyz [N,3] f32, a codes table
// [S, Lt] bf16 and a shape id sids[p] in [0, S)):
//   z = codes[sids[p]], x = bf16(xyz[p])
//   layer 0      : h = bf16(relu(z @ W_z^T + x . w_x + b))
//   hidden layer : h = bf16(relu(h @ W_h^T [+ z @ W_z^T + x . w_x] + b))
//   final layer  : sdf = h . w + b, optional tanh
// Products are bf16 x bf16 with f32 accumulation; every hidden activation
// is re-rounded to bf16: the arithmetic of ops/fused_decoder.py::fast_apply
// in bf16 over codes[sids] (the plain version this kernel is held against),
// summed in another order (one accumulator holds the hidden product, then
// the latent and xyz product, then the bias is added).
//
// Bound on this card: the canonical 8x512 plan with L = 256 does 1,835,520
// multiply-adds per point against 20 bytes of input/output per point (xyz,
// a 4-byte shape id, sdf) plus the codes table and the weights once, so it
// is compute-bound: 3.89 ms per 2^20 points at 989 TFLOP/s bf16.
//
// What bound the previous design (64-point tiles with mma.sync, weights
// streamed from L2 into registers by every tile): each byte of weights read
// from L2 fed 64 points, 64 FLOP per byte, so at 300 TFLOP/s the kernel
// pulled ~4.7 TB/s out of L2, about all that L2 delivers.
//
// Design:
//  * A cluster of CLUSTER CTAs (2: on an H100 faster than 1 or 4,
//    tools/pairs_probe.py), one CTA per SM, each evaluating a 64-point
//    tile at a time. The CTAs of a cluster walk the same weight stream in
//    lock step: every weight slab is fetched from L2 once per cluster and
//    multicast into the shared memory of all its CTAs, so each byte read
//    from L2 feeds 64 x CLUSTER points.
//  * The weight stream is packed by the wrapper (ops/cuda_kernels.py,
//    pack_weights_pairs) as slabs, one per k16 step of every layer's
//    products in the order the kernel consumes them: for each layer its
//    hidden slabs, then its latent slabs, padded with zero slabs to whole
//    ring stages. A slab holds the layer's n output rows x 16 inputs in
//    wgmma's canonical K-major layout without swizzle (8x8 core matrices of
//    128 contiguous bytes: conflict-free reads), so a 1-D bulk copy
//    (cp.async.bulk, multicast::cluster) lands it ready for wgmma; no tensor
//    map. Each CTA's producer thread copies 1/CLUSTER of every slab and
//    multicasts it into a ring of STAGES stages of STAGE_SLABS 16 KB slots,
//    paced by full (transaction-count) and empty (2 x CLUSTER consumer
//    arrivals) mbarriers.
//  * A producer warpgroup (56 registers a thread by setmaxnreg) and two
//    consumer warpgroups (224 registers) that each own one half of a
//    layer's output columns (up to 256: m64n256k16, 128 f32 accumulators a
//    thread), both operands from shared memory: per stage one barrier
//    wait, STAGE_SLABS wgmmas (an unrolled loop: no divergent path between
//    them, so ptxas keeps them asynchronous), one commit, and the previous
//    stage released to every CTA of the cluster.
//  * The tile's activations live in one 64 x 512 bf16 buffer in the same
//    core-matrix layout: a layer's product reads all of it before the
//    epilogue overwrites it in place (bias, relu, bf16 in one cvt, stored
//    by stmatrix), so no ping-pong buffer is needed. The last hidden
//    layer's epilogue keeps h in registers and folds the final layer in.
//    The latent operand is a second buffer [64, lzx]: the tile's code rows,
//    copied from the codes table by shape id (cp.async, 16 bytes a thread),
//    then bf16(xyz) and zeros; the wrapper packs [W_z | W_x | 0] to match,
//    so the xyz term runs on the tensor cores with the latent product. The
//    next tile's rows are fetched as soon as the last latent layer of the
//    current tile has read them, their ids a tile ahead.
//  * Persistent: the grid is the number of co-resident clusters (or fewer
//    for small N); clusters walk the tiles, and the producer runs ahead
//    into the next tile's slabs while the last layers finish.
//  * Widths pad to 64, 128, 256 or 512 (wgmma N per warpgroup 32-256), the
//    latent to a multiple of 8 (table) and 16 (with xyz), with zeros.
// Shared memory at L = 256: 65,536 (activations) + 34,816 (latent tile,
// lzx 272) + 512 (layer table) + 4 x 32,784 (stages and barriers) =
// 232,000 bytes.
//
// What bounds it now (tools/pairs_probe.py, H100 80GB HBM3 at 700 W,
// 2^19 points): 3.1 ms, 63% of the bound. The same kernel without its
// bulk copies takes 2.9 ms and without its wgmmas 2.4 ms: the products,
// their per-stage barrier round and the epilogues on the tensor cores'
// critical path bind, more than the weight stream. A 64-row tile is what
// shared memory allows with 512-wide activations kept on chip, so every
// 16 KB slab carries only 256 clocks of tensor work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int TILE_M = 64;
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int THREADS = CONSUMERS + 128;       // and the producer's warpgroup
constexpr int PRODUCER_REGS = 56;              // setmaxnreg: 128 x 56 +
constexpr int CONSUMER_REGS = 224;             //   256 x 224 <= 65,536
constexpr int MAX_WIDTH = 512;
constexpr int MAX_LATENT = 512;
constexpr int MAX_LAYERS = 16;
constexpr int MAX_SLOTS = 8;
constexpr int STAGE_SLABS = 2;    // k16 slabs per ring stage (one barrier round)
// every layer's slab count is a multiple of STAGE_SLABS: the wrapper pads
// the latent slabs with zero slabs, whose A operand is any finite tile
constexpr int CLUSTER = 2;        // CTAs that share every weight slab
constexpr int SMEM_LIMIT = 232448;             // dynamic shared memory a block may use
constexpr int ACT_BYTES = TILE_M * MAX_WIDTH * 2;
constexpr int SLOT_BYTES = MAX_WIDTH * 16 * 2;  // one k16 slab of the widest layer
constexpr int STAGE_BYTES = STAGE_SLABS * SLOT_BYTES;
// wgmma K-major, no swizzle: byte strides between 8x8 core matrices
constexpr int SLAB_LBO = 128;    // slab: next 8 inputs (k)
constexpr int SLAB_SBO = 256;    // slab: next 8 output rows (n)
constexpr int TILE_LBO = 1024;   // activation / latent tile: next 8 inputs
constexpr int TILE_SBO = 128;    // activation / latent tile: next 8 points

struct Layer {
  int k;               // padded hidden input width (0: layer 0; final: its input)
  int n;               // padded output width (1: final layer)
  int kz;              // latent + xyz input width (lzx) or 0
  long long w_off;     // bf16 offset of the layer's slabs (final: its weight vector)
  long long row_off;   // f32 offset of the bias row
};

struct Plan {
  int n_layers, use_tanh, lt, lzx, last_z, stages, n_codes;
  long long n_points;
  Layer layers[MAX_LAYERS];
};

constexpr int TABLE_BYTES = MAX_LAYERS * static_cast<int>(sizeof(Layer));

// activations, latent tile, the layer table, then the ring's stages and
// their full and empty barriers
int smem_bytes(int lzx, int stages) {
  return ACT_BYTES + TILE_M * lzx * 2 + TABLE_BYTES +
         stages * (STAGE_BYTES + 16);
}

int stages_for(int lzx) {
  const int s = (SMEM_LIMIT - ACT_BYTES - TILE_M * lzx * 2 - TABLE_BYTES) /
                (STAGE_BYTES + 16);
  return s < MAX_SLOTS / STAGE_SLABS ? s : MAX_SLOTS / STAGE_SLABS;
}

__device__ __forceinline__ int padded_slabs(int n) {
  return (n + STAGE_SLABS - 1) / STAGE_SLABS * STAGE_SLABS;
}

// element offset of (point m, input c) in a tile buffer (activations, latent)
__device__ __forceinline__ int tile_off(int m, int c) {
  return ((c >> 3) * 8 + (m >> 3)) * 64 + (m & 7) * 8 + (c & 7);
}

using namespace sm90;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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

// One warpgroup's part of a layer's products: acc[64, NW] = act[64, k] @
// W_h[cols, k]^T + zt[64, kz] @ W_zx[cols, kz]^T, cols = wg * NW + [0, NW),
// one slab per k16 step, up to STAGE_SLABS slabs per ring stage; each stage
// goes back to the cluster once its wgmmas have read it.
template <int NW>
__device__ __forceinline__ void layer_products(float (&acc)[NW / 2],
                                               uint32_t act, uint32_t zt,
                                               int kh, int kz, int wg,
                                               uint32_t leader, Ring& ring) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const int hsteps = kh / 16, zsteps = kz / 16;
  const int steps = hsteps + padded_slabs(zsteps);
  const uint32_t b_off = static_cast<uint32_t>(wg * (NW / 8) * SLAB_SBO);
  int prev = -1;
  for (int t0 = 0; t0 < steps; t0 += STAGE_SLABS) {
    mbar_wait(ring.full + ring.stage * 8, ring.phase);
    wgmma_fence();
    const uint32_t slab = ring.slots + ring.stage * STAGE_BYTES + b_off;
#pragma unroll
    for (int i = 0; i < STAGE_SLABS; ++i) {
      const int t = t0 + i, tz = t - hsteps;
      const uint32_t a = t < hsteps ? act + t * 2 * TILE_LBO
                                    : zt + (tz < zsteps ? tz : 0) * 2 * TILE_LBO;
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

// h[64, cols] = bf16(relu(acc + b)) into the activation tile, in place.
// The accumulator of column block j, row half e is the 8x8 fragment that
// stmatrix stores; one stmatrix.x4 writes blocks j, j+1, both halves. Lane
// l gives the address of row l % 8 of matrix l / 8 (block +l/16, half
// (l/8) % 2); each such row is 16 contiguous bytes of the tile layout.
template <int NW>
__device__ __forceinline__ void layer_epilogue(const float (&acc)[NW / 2],
                                               uint32_t act,
                                               const float* bias, int wg,
                                               int warp, int lane) {
  const int q = lane % 4, mi = lane / 8;
  const float* b = bias + wg * NW + 2 * q;
  const uint32_t base =
      act + 2 * tile_off(16 * warp + 8 * (mi & 1) + lane % 8,
                         wg * NW + 8 * (mi >> 1));
#pragma unroll
  for (int j = 0; j < NW / 8; j += 2) {
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(b + 8 * j));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(b + 8 * j + 8));
    stmatrix_x4(base + j * 1024,
                bf16x2_relu(acc[4 * j] + b0.x, acc[4 * j + 1] + b0.y),
                bf16x2_relu(acc[4 * j + 2] + b0.x, acc[4 * j + 3] + b0.y),
                bf16x2_relu(acc[4 * j + 4] + b1.x, acc[4 * j + 5] + b1.y),
                bf16x2_relu(acc[4 * j + 6] + b1.x, acc[4 * j + 7] + b1.y));
  }
}

// The last hidden layer with the final layer folded in: h = bf16(relu(acc
// + b)) stays in registers; each thread dots its columns with the final
// weight, the 4 lanes of a row and then the two warpgroups (through `red`,
// [2][64] f32) sum the partials.
template <int NW>
__device__ __forceinline__ void final_fold(const float (&acc)[NW / 2],
                                           const float* bias,
                                           const __nv_bfloat16* wf, float* red,
                                           int wg, int warp, int lane) {
  const int g = lane / 4, q = lane % 4;
  const float* b = bias + wg * NW + 2 * q;
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

// The shape id of this thread's point in the tile at m0 (4 threads a
// point; 0 past N), loaded a tile ahead of load_latent_tile, which checks it.
__device__ __forceinline__ int point_sid(const int* sids, long long m0,
                                         long long n_points, int tid) {
  const long long p = m0 + tid / 4;
  return p < n_points ? __ldg(sids + p) : 0;
}

// The tile's latent operand: code rows by shape id (cp.async), bf16(xyz),
// zeros; zeros for points past N. 4 threads a point, each every 4th
// 16-byte chunk of the row. Waited for by load_wait().
__device__ __forceinline__ void load_latent_tile(
    __nv_bfloat16* zt, const __nv_bfloat16* codes, int sid, const float* xyz,
    long long m0, long long n_points, int n_codes, int lt, int lzx, int tid) {
  const int m = tid / 4, part = tid % 4;
  const int chunks = lzx / 8, zchunks = lt / 8;
  const long long p = m0 + m;
  const bool valid = p < n_points;
  if (valid && (sid < 0 || sid >= n_codes)) __trap();
  const __nv_bfloat16* row = codes + static_cast<long long>(sid) * lt;
  __nv_bfloat16* dst = zt + tile_off(m, 0);
  for (int c = part; c < chunks; c += 4) {
    if (valid && c < zchunks) {
      cp_async16(smem_u32(dst + c * 512), row + c * 8);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (valid && c == zchunks) {
        const __nv_bfloat162 xy = __floats2bfloat162_rn(
            __ldg(xyz + p * 3), __ldg(xyz + p * 3 + 1));
        const __nv_bfloat162 z0 =
            __floats2bfloat162_rn(__ldg(xyz + p * 3 + 2), 0.f);
        v.x = *reinterpret_cast<const uint32_t*>(&xy);
        v.y = *reinterpret_cast<const uint32_t*>(&z0);
      }
      *reinterpret_cast<uint4*>(dst + c * 512) = v;
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void load_wait() {
  cp_async_wait_all();
  fence_async_smem();
  consumer_sync();
}

// One hidden layer of the tile. The last one (wf: the final layer's
// weight) leaves its partial sdf sums in `red` (the start of the then free
// activation tile) instead of writing h.
template <int NW>
__device__ __forceinline__ void run_layer(__nv_bfloat16* act, __nv_bfloat16* zt,
                                          const Layer& L, const float* rows,
                                          int wg, int warp, int lane,
                                          uint32_t leader, Ring& ring,
                                          bool last_z, bool has_next,
                                          const float* xyz,
                                          const __nv_bfloat16* codes,
                                          int next_sid, long long next_m0,
                                          const __nv_bfloat16* wf,
                                          const Plan& plan, int tid) {
  float acc[NW / 2];
  layer_products<NW>(acc, smem_u32(act), smem_u32(zt), L.k, L.kz, wg, leader,
                     ring);
  consumer_sync();                  // both warpgroups have read act and zt
  if (last_z && has_next)
    load_latent_tile(zt, codes, next_sid, xyz, next_m0, plan.n_points,
                     plan.n_codes, plan.lt, plan.lzx, tid);
  if (wf != nullptr) {
    final_fold<NW>(acc, rows + L.row_off, wf, reinterpret_cast<float*>(act),
                   wg, warp, lane);
  } else {
    layer_epilogue<NW>(acc, smem_u32(act), rows + L.row_off, wg, warp, lane);
    fence_async_smem();
  }
  consumer_sync();
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_eval_pairs_kernel(const float* __restrict__ xyz,
                            const __nv_bfloat16* __restrict__ codes,
                            const int* __restrict__ sids,
                            float* __restrict__ out, long long n_points,
                            const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ rows,
                            const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* zt = act + TILE_M * MAX_WIDTH;   // latent tile [64, lzx]
  Layer* layers = reinterpret_cast<Layer*>(smem + ACT_BYTES +
                                           TILE_M * plan.lzx * 2);
  unsigned char* slots = reinterpret_cast<unsigned char*>(layers) + TABLE_BYTES;
  Ring ring;
  ring.stages = plan.stages;
  ring.slots = smem_u32(slots);
  ring.full = ring.slots + plan.stages * STAGE_BYTES;
  ring.empty = ring.full + plan.stages * 8;

  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform to the compiler (no divergent path around the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const uint32_t rank = cluster_rank();
  if (tid < plan.n_layers) layers[tid] = plan.layers[tid];
  if (tid == 0) {
    for (int s = 0; s < plan.stages; ++s) {
      mbar_init(ring.full + s * 8, 1);
      mbar_init(ring.empty + s * 8, 2 * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  // clusters walk the tiles; the CTAs of one cluster stay in lock step
  const long long n_tiles = (n_points + TILE_M - 1) / TILE_M;
  const long long stride = static_cast<long long>(gridDim.x);
  const long long base0 =
      static_cast<long long>(blockIdx.x / CLUSTER) * CLUSTER;

  if (warp >= CONSUMERS / 32) {
    // producer: every slab of every layer, tile after tile (one thread)
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      constexpr uint16_t mask = (1u << CLUSTER) - 1u;
      const char* wb = reinterpret_cast<const char*>(w);
      for (long long base = base0; base < n_tiles; base += stride) {
        for (int li = 0; li < plan.n_layers - 1; ++li) {
          const Layer& L = layers[li];
          const uint32_t bytes = static_cast<uint32_t>(L.n) * 32u;
          const uint32_t share = bytes / CLUSTER;
          const int steps = L.k / 16 + padded_slabs(L.kz / 16);
          const char* src = wb + L.w_off * 2 + rank * share;
          for (int t0 = 0; t0 < steps; t0 += STAGE_SLABS) {
            const uint32_t full = ring.full + ring.stage * 8;
            mbar_wait(ring.empty + ring.stage * 8, ring.phase ^ 1u);
            mbar_expect_tx(full, bytes * STAGE_SLABS);
#pragma unroll
            for (int i = 0; i < STAGE_SLABS; ++i)
              bulk_copy(ring.slots + ring.stage * STAGE_BYTES +
                            i * SLOT_BYTES + rank * share,
                        src + static_cast<long long>(t0 + i) * bytes, share,
                        full, mask, CLUSTER > 1);
            ring.advance();
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();   // no CTA leaves while its cluster may still write to it
  } else {
    // consumers: two warpgroups
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, wwarp = warp % 4;
    const uint32_t leader = (tid % 128) == 0;
    const Layer& F = layers[plan.n_layers - 1];
    if (base0 < n_tiles) {
      const long long m0 = (base0 + rank) * TILE_M;
      load_latent_tile(zt, codes, point_sid(sids, m0, n_points, tid), xyz,
                       m0, n_points, plan.n_codes, plan.lt, plan.lzx, tid);
    }
    for (long long base = base0; base < n_tiles; base += stride) {
      const long long m0 = (base + rank) * TILE_M;
      const bool has_next = base + stride < n_tiles;
      const long long next_m0 = (base + stride + rank) * TILE_M;
      const int next_sid =
          has_next ? point_sid(sids, next_m0, n_points, tid) : 0;
      load_wait();
      for (int li = 0; li < plan.n_layers - 1; ++li) {
        const Layer& L = layers[li];
        const bool last_z = li == plan.last_z;
        const __nv_bfloat16* wf =
            li == plan.n_layers - 2 ? w + F.w_off : nullptr;
        switch (L.n) {
          case 512:
            run_layer<256>(act, zt, L, rows, wg, wwarp, lane, leader,
                           ring, last_z, has_next, xyz, codes,
                           next_sid, next_m0, wf, plan, tid);
            break;
          case 256:
            run_layer<128>(act, zt, L, rows, wg, wwarp, lane, leader,
                           ring, last_z, has_next, xyz, codes,
                           next_sid, next_m0, wf, plan, tid);
            break;
          case 128:
            run_layer<64>(act, zt, L, rows, wg, wwarp, lane, leader,
                          ring, last_z, has_next, xyz, codes,
                          next_sid, next_m0, wf, plan, tid);
            break;
          default:
            run_layer<32>(act, zt, L, rows, wg, wwarp, lane, leader,
                          ring, last_z, has_next, xyz, codes,
                          next_sid, next_m0, wf, plan, tid);
            break;
        }
      }
      // final layer: the two warpgroups' partial sums, the bias, tanh
      if (tid < TILE_M && m0 + tid < n_points) {
        const float* red = reinterpret_cast<const float*>(act);
        float v = red[tid] + red[TILE_M + tid] + rows[F.row_off];
        if (plan.use_tanh) v = tanhf(v);
        out[m0 + tid] = v;
      }
    }
    cluster_sync();
  }
}

}  // namespace

extern "C" {

// The launch configuration for a latent width lzx: ring stages, dynamic
// shared memory, the clusters that fit on the card at once (0 if none) and
// their size. Returns the cudaError_t of the query.
int fused_eval_pairs_config(int lzx, int* stages, int* smem,
                            int* max_clusters, int* cluster) {
  if (lzx < 16 || lzx % 16 != 0 || lzx > MAX_LATENT + 16)
    return static_cast<int>(cudaErrorInvalidValue);
  *stages = stages_for(lzx);
  *smem = smem_bytes(lzx, *stages);
  *cluster = CLUSTER;
  static int cached_smem = 0, cached_clusters = 0;
  if (cached_smem != *smem) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_eval_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LIMIT);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(CLUSTER * 132);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = *smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, fused_eval_pairs_kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached_smem = *smem;
    cached_clusters = n;
  }
  *max_clusters = cached_clusters;
  return 0;
}

// xyz [n_points, 3] f32; codes [n_codes, lt] bf16, lt a multiple of 8,
// 16-byte aligned; sids [n_points] int32 in [0, n_codes) (a point with an
// id outside traps the kernel); w: the slab stream of pack_weights_pairs,
// 16-byte aligned; rows: the f32 biases; meta: n_layers rows of 5 int64
// (k, n, kz, w_off, row_off), host memory; lzx: the latent + xyz width
// (a multiple of 16, >= lt + 3). Returns the cudaError_t of the launch.
int fused_eval_pairs_launch(const float* xyz, const void* codes, int lt,
                            int n_codes, const int* sids, float* out,
                            long long n_points, const void* w,
                            const float* rows, const long long* meta,
                            int n_layers, int lzx, int use_tanh,
                            void* stream) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || lt < 8 || lt % 8 != 0 ||
      lt > MAX_LATENT || lzx < lt + 3 || n_codes < 1 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int stages = 0, smem = 0, max_clusters = 0, cluster = 0;
  int e = fused_eval_pairs_config(lzx, &stages, &smem, &max_clusters, &cluster);
  if (e != 0) return e;
  if (stages < 2 || max_clusters < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Plan plan;
  plan.n_layers = n_layers;
  plan.use_tanh = use_tanh;
  plan.lt = lt;
  plan.lzx = lzx;
  plan.last_z = -1;
  plan.stages = stages;
  plan.n_codes = n_codes;
  plan.n_points = n_points;
  int prev_n = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long* r = meta + 5 * i;
    Layer L{static_cast<int>(r[0]), static_cast<int>(r[1]),
            static_cast<int>(r[2]), r[3], r[4]};
    const bool final = i == n_layers - 1;
    const bool width_ok = final ? L.n == 1
                                : (L.n == 64 || L.n == 128 || L.n == 256 ||
                                   L.n == MAX_WIDTH);
    if (!width_ok || L.k != prev_n || (L.kz != 0 && L.kz != lzx) ||
        (!final && (L.k / 16) % STAGE_SLABS != 0) ||
        (final && L.kz != 0) || (i == 0 && L.kz == 0) || L.w_off % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (L.kz) plan.last_z = i;
    plan.layers[i] = L;
    prev_n = L.n;
  }
  if (n_points <= 0) return 0;
  const long long n_tiles = (n_points + TILE_M - 1) / TILE_M;
  const long long want = (n_tiles + CLUSTER - 1) / CLUSTER;
  const int clusters = static_cast<int>(want < max_clusters ? want : max_clusters);
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
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_eval_pairs_kernel, xyz,
      static_cast<const __nv_bfloat16*>(codes), sids, out, n_points,
      static_cast<const __nv_bfloat16*>(w), rows, plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Widest padded layer and latent the shared-memory buffers hold.
int fused_eval_pairs_max_width() { return MAX_WIDTH; }
int fused_eval_pairs_max_latent() { return MAX_LATENT; }

// The shared-memory layout the wrapper packs for: slab bytes per slot, the
// core-matrix strides of slabs and tiles (LBO, SBO), and the slabs per ring
// stage (each layer's latent slabs padded to a multiple of it).
void fused_eval_pairs_layout(int* out) {
  out[0] = SLOT_BYTES;
  out[1] = SLAB_LBO;
  out[2] = SLAB_SBO;
  out[3] = TILE_LBO;
  out[4] = TILE_SBO;
  out[5] = STAGE_SLABS;
}

}  // extern "C"
