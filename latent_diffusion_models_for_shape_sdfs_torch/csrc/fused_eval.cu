// Fused SDF-decoder evaluation for one latent over a batch of points,
// designed for Hopper (sm_90a): wgmma, a shared-memory weight ring fed by
// bulk copies that a thread-block cluster shares, and persistent CTAs.
//
// Replaces the TPU kernel `_build_eval_kernel` / `make_pallas_apply` in
// latent_diffusion_models_for_shape_sdfs_tpu/ops/pallas_kernels.py:46, the
// evaluator under every single-latent grid decode (serve_meshes,
// watch_and_serve, generate_meshes, the per-shape decode).
//
// What it computes, for points p < N (xyz [N,3] f32), x = bf16(xyz[p]):
//   layer 0      : h = bf16(relu(x . w_x + row))
//   hidden layer : h = bf16(relu(h @ W_h^T [+ x . w_x] + row))
//   final layer  : sdf = h . w + row, optional tanh
// `row` is the layer's f32 bias row, given per launch: for layer 0 and the
// skip layers the wrapper has added the hoisted latent product b + bf16(z)
// @ W_z (as the TPU kernel's caller does, pallas_kernels.py:137-142), so
// the kernel runs only per-point products. Products are bf16 x bf16 with
// f32 accumulation and every hidden activation is re-rounded to bf16: the
// arithmetic of ops/fused_decoder.py::fast_apply in bf16 (the plain
// version this kernel is held against), summed in another order (one
// accumulator holds the hidden product, then the xyz product, then the
// row is added).
//
// Bound on this card: the canonical 8x512 plan (L = 256, latent_in 4)
// needs 1,573,376 multiply-adds per point against 16 bytes of input and
// output per point plus the weights once, so it is operations-bound: 3.34
// ms per 2^20 points at 989 TFLOP/s bf16. With its padding (each xyz term
// one k16 slab and a zero slab, 253 -> 256) the tensor cores run ~1.61M.
//
// What bound the previous design (64-point tiles, mma.sync, 8 warps, each
// warp reading its weight fragments from L2 into registers for every
// tile): each byte of weights read from L2 fed only 64 points, 64 FLOP per
// L2 byte, so the kernel ran at ~290 TFLOP/s, about all that L2 delivers
// (11.4 ms per 2^20 points).
//
// Design: the engine of csrc/eval_engine.cuh (shared with kernel #2,
// csrc/fused_eval_pairs.cu): a cluster of 2 CTAs multicasting 16 KB k16
// weight slabs into a shared-memory ring, so each weight byte read from L2
// feeds 128 points; two consumer warpgroups of wgmma on 64-point tiles
// whose activations stay in shared memory; a producer warpgroup.
//  * The per-point tile is xyz alone: [64, 16] bf16 (x, y, z, then
//    zeros), loaded into registers a tile ahead and written at the start
//    of the tile. Layer 0 and the skip layers carry one [W_x | 0] slab
//    and a zero slab that pads it to a whole ring stage; no latent tile,
//    codes table or ids: the rows carry the latent products.
//  * Persistent: the grid is the number of co-resident clusters, or fewer
//    when the tiles need fewer (a 4,096-point launch has 64 tiles: 32
//    clusters, none idle); clusters walk the tiles, and the producer runs
//    ahead into the next tile's slabs while the last layers finish.
//    Points at or past N are computed from zeros and never stored.
//  * Widths pad to 64, 128, 256 or 512 (wgmma N per warpgroup 32-256).
// Shared memory: 65,536 (activations) + 2,048 (xyz tile) + 512 (layer
// table) + 5 x 32,784 (stages and barriers) = 232,016 of 232,448 bytes.
// Without #2's 34,816-byte latent tile the ring holds 5 stages of 2 slabs
// (#2: 4), the most that fit: tools/eval_probe.py measured 3 and 4 stages
// slower (H100, 2^20 points: 5.36 and 5.65 ms against 5.00).
//
// What bounds it (tools/eval_probe.py, H100 80GB HBM3 at 700 W, 2^20
// points): 5.00 ms, 67% of the bound. Without its wgmmas and bulk copies
// it still takes 2.23 ms, without its wgmmas 3.77, without the hidden
// layers' epilogues 4.56, without its bulk copies 4.70: the per-stage
// barrier rounds and the syncs and epilogues between layers, on the
// tensor cores' critical path, bind more than the products or the weight
// stream, as in #2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "eval_engine.cuh"

namespace {

using namespace eval_engine;

constexpr int XYZ_COLS = 16;      // the xyz tile: bf16 x, y, z, then zeros
constexpr int STAGES = 5;         // ring stages: the most shared memory holds
constexpr int XYZ_BYTES = TILE_M * XYZ_COLS * 2;

struct Plan {
  int n_layers, use_tanh;
  Layer layers[MAX_LAYERS];   // k2: XYZ_COLS for layer 0 and the skip layers
};

// activations, xyz tile, the layer table, then the ring's stages and their
// full and empty barriers
constexpr int SMEM_BYTES =
    ACT_BYTES + XYZ_BYTES + TABLE_BYTES + STAGES * (STAGE_BYTES + 16);
static_assert(SMEM_BYTES <= SMEM_LIMIT, "the ring does not fit");

// xyz of this thread's point in the tile at m0 (one thread a point, tid <
// TILE_M; zeros past N and for the other threads), loaded a tile ahead of
// store_xyz, which rounds it to bf16.
__device__ __forceinline__ float3 point_xyz(const float* xyz, long long m0,
                                            long long n_points, int tid) {
  const long long p = m0 + tid;
  float3 v = make_float3(0.f, 0.f, 0.f);
  if (tid < TILE_M && p < n_points)
    v = make_float3(__ldg(xyz + p * 3), __ldg(xyz + p * 3 + 1),
                    __ldg(xyz + p * 3 + 2));
  return v;
}

// Columns 0-7 of the point's xyz tile row: bf16 x, y, z, zeros (columns
// 8-15 stay as zeroed at the start).
__device__ __forceinline__ void store_xyz(__nv_bfloat16* xt, float3 v,
                                          int tid) {
  if (tid < TILE_M) {
    const __nv_bfloat162 xy = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 z0 = __floats2bfloat162_rn(v.z, 0.f);
    *reinterpret_cast<uint4*>(xt + tile_off(tid, 0)) =
        make_uint4(*reinterpret_cast<const uint32_t*>(&xy),
                   *reinterpret_cast<const uint32_t*>(&z0), 0u, 0u);
  }
}

// One hidden layer of the tile. The last one (wf: the final layer's
// weight) leaves its partial sdf sums in `red` (the start of the then free
// activation tile) instead of writing h.
template <int NW>
__device__ __forceinline__ void run_layer(__nv_bfloat16* act, uint32_t xt,
                                          const Layer& L, const float* rows,
                                          int wg, int warp, int lane,
                                          uint32_t leader, Ring& ring,
                                          const __nv_bfloat16* wf) {
  float acc[NW / 2];
  layer_products<NW>(acc, smem_u32(act), xt, L.k, L.k2, wg, leader, ring);
  consumer_sync();                  // both warpgroups have read act
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
    fused_eval_kernel(const float* __restrict__ xyz, float* __restrict__ out,
                      long long n_points, const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ rows,
                      const __grid_constant__ Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* act = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xt = act + TILE_M * MAX_WIDTH;   // xyz tile [64, 16]
  Layer* layers = reinterpret_cast<Layer*>(smem + ACT_BYTES + XYZ_BYTES);
  unsigned char* slots = reinterpret_cast<unsigned char*>(layers) + TABLE_BYTES;
  Ring ring;
  ring.stages = STAGES;
  ring.slots = smem_u32(slots);
  ring.full = ring.slots + STAGES * STAGE_BYTES;
  ring.empty = ring.full + STAGES * 8;

  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform to the compiler (no divergent path around the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const uint32_t rank = cluster_rank();
  if (tid < plan.n_layers) layers[tid] = plan.layers[tid];
  if (tid < XYZ_BYTES / 16)         // the xyz tile's zeros
    reinterpret_cast<uint4*>(xt)[tid] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
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
    const __nv_bfloat16* wf = w + F.w_off;
    float3 next = point_xyz(xyz, (base0 + rank) * TILE_M, n_points, tid);
    for (long long base = base0; base < n_tiles; base += stride) {
      const long long m0 = (base + rank) * TILE_M;
      // this tile's xyz (the previous tile's layers have read the tile),
      // then the next tile's into registers
      store_xyz(xt, next, tid);
      next = point_xyz(xyz, (base + stride + rank) * TILE_M, n_points, tid);
      fence_async_smem();
      consumer_sync();
      for (int li = 0; li < plan.n_layers - 1; ++li) {
        const Layer& L = layers[li];
        const __nv_bfloat16* f = li == plan.n_layers - 2 ? wf : nullptr;
        switch (L.n) {
          case 512:
            run_layer<256>(act, smem_u32(xt), L, rows, wg, wwarp, lane,
                           leader, ring, f);
            break;
          case 256:
            run_layer<128>(act, smem_u32(xt), L, rows, wg, wwarp, lane,
                           leader, ring, f);
            break;
          case 128:
            run_layer<64>(act, smem_u32(xt), L, rows, wg, wwarp, lane,
                          leader, ring, f);
            break;
          default:
            run_layer<32>(act, smem_u32(xt), L, rows, wg, wwarp, lane,
                          leader, ring, f);
            break;
        }
      }
      // final layer: the two warpgroups' partial sums, the row, tanh
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

// The launch configuration: ring stages, dynamic shared memory, the
// clusters that fit on the card at once (0 if none) and their size.
// Returns the cudaError_t of the query.
int fused_eval_config(int* stages, int* smem, int* max_clusters,
                      int* cluster) {
  *stages = STAGES;
  *smem = SMEM_BYTES;
  *cluster = CLUSTER;
  static int cached_clusters = -1;
  if (cached_clusters < 0) {
    int n = 0;
    const int e = resident_clusters(fused_eval_kernel, SMEM_BYTES, &n);
    if (e != 0) return e;
    cached_clusters = n;
  }
  *max_clusters = cached_clusters;
  return 0;
}

// xyz [n_points, 3] f32; w: the slab stream of pack_weights, 16-byte
// aligned; rows: every layer's f32 row (hoisted_rows), 8-byte aligned;
// meta: n_layers rows of 5 int64 (k, n, k2, w_off, row_off), host memory.
// Returns the cudaError_t of the launch (0 = success).
int fused_eval_launch(const float* xyz, float* out, long long n_points,
                      const void* w, const float* rows, const long long* meta,
                      int n_layers, int use_tanh, void* stream) {
  if (n_layers < 2 || n_layers > MAX_LAYERS || n_points < 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int stages = 0, smem = 0, max_clusters = 0, cluster = 0;
  int e = fused_eval_config(&stages, &smem, &max_clusters, &cluster);
  if (e != 0) return e;
  if (max_clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  Plan plan;
  plan.n_layers = n_layers;
  plan.use_tanh = use_tanh;
  int prev_n = 0;
  for (int i = 0; i < n_layers; ++i) {
    const long long* r = meta + 5 * i;
    Layer L{static_cast<int>(r[0]), static_cast<int>(r[1]),
            static_cast<int>(r[2]), r[3], r[4]};
    const bool final = i == n_layers - 1;
    const bool width_ok = final ? L.n == 1
                                : (L.n == 64 || L.n == 128 || L.n == 256 ||
                                   L.n == MAX_WIDTH);
    if (!width_ok || L.k != prev_n || (L.k2 != 0 && L.k2 != XYZ_COLS) ||
        (!final && (L.k / 16) % STAGE_SLABS != 0) ||
        (final && L.k2 != 0) || (i == 0 && L.k2 == 0) || L.w_off % 8 != 0 ||
        L.row_off % 2 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    plan.layers[i] = L;
    prev_n = L.n;
  }
  if (n_points == 0) return 0;
  return launch_clusters(fused_eval_kernel, n_points, max_clusters,
                         SMEM_BYTES, stream, xyz, out, n_points,
                         static_cast<const __nv_bfloat16*>(w), rows, plan);
}

// Widest padded layer the shared-memory activation tile holds.
int fused_eval_max_width() { return MAX_WIDTH; }

// The shared-memory layout the wrapper packs for: slab bytes per slot, the
// core-matrix strides of slabs and tiles (LBO, SBO), the slabs per ring
// stage (each xyz slab is padded with zero slabs to a multiple of it) and
// the xyz tile's width (the xyz slab's inputs).
void fused_eval_layout(int* out) {
  out[0] = SLOT_BYTES;
  out[1] = SLAB_LBO;
  out[2] = SLAB_SBO;
  out[3] = TILE_LBO;
  out[4] = TILE_SBO;
  out[5] = STAGE_SLABS;
  out[6] = XYZ_COLS;
}

}  // extern "C"
