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
// Design: the engine of csrc/eval_engine.cuh (shared with kernel #1,
// csrc/fused_eval.cu: the slab stream, the weight ring multicast across a
// cluster, producer and consumer warpgroups, the in-place activation tile
// and the final fold), with a latent tile as the per-point operand.
//  * A cluster of CLUSTER CTAs (2: on an H100 faster than 1 or 4,
//    tools/pairs_probe.py), one CTA per SM, each evaluating a 64-point
//    tile at a time. The weight stream (ops/cuda_kernels.py,
//    pack_weights_pairs) holds for each layer its hidden slabs, then its
//    latent slabs, padded with zero slabs to whole ring stages.
//  * The latent operand is a second buffer [64, lzx]: the tile's code rows,
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

#include "eval_engine.cuh"

namespace {

using namespace eval_engine;

constexpr int MAX_LATENT = 512;
constexpr int MAX_SLOTS = 8;
// every layer's slab count is a multiple of STAGE_SLABS: the wrapper pads
// the latent slabs with zero slabs, whose A operand is any finite tile

struct Plan {
  int n_layers, use_tanh, lt, lzx, last_z, stages, n_codes;
  long long n_points;
  Layer layers[MAX_LAYERS];   // k2: the latent + xyz width lzx, or 0
};

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
  layer_products<NW>(acc, smem_u32(act), smem_u32(zt), L.k, L.k2, wg, leader,
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
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0)
      produce(layers, plan.n_layers, w, rank, base0, n_tiles, stride, ring);
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
    int n = 0;
    const int e = resident_clusters(fused_eval_pairs_kernel, *smem, &n);
    if (e != 0) return e;
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
// (k, n, k2, w_off, row_off), host memory; lzx: the latent + xyz width
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
    if (!width_ok || L.k != prev_n || (L.k2 != 0 && L.k2 != lzx) ||
        (!final && (L.k / 16) % STAGE_SLABS != 0) ||
        (final && L.k2 != 0) || (i == 0 && L.k2 == 0) || L.w_off % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (L.k2) plan.last_z = i;
    plan.layers[i] = L;
    prev_n = L.n;
  }
  if (n_points <= 0) return 0;
  return launch_clusters(fused_eval_pairs_kernel, n_points, max_clusters,
                         smem, stream, xyz,
                         static_cast<const __nv_bfloat16*>(codes), sids, out,
                         n_points, static_cast<const __nv_bfloat16*>(w), rows,
                         plan);
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
