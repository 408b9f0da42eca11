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
//             as the TPU kernel does: here from one keep bit per element,
//             bf16(h) > 0, written beside h by the forward), dW_h = g^T h
//             (f32), db = sum g, and at layer 0 and the skip layer gsum_s =
//             sum of g over the scene, dW_z = gsum^T z, dW_x = g^T xyz,
//             dz_s += bf16(gsum_s) W_z.
// Dropout bits: Philox4x32-10 of (row = point index, col) keyed by
// seed + 7919 * layer (philox.cuh), the same mask as csrc/relu_dropout.cu.
// The TPU kernel rounds each 256-point tile's gsum to bf16 before the dz
// product; this one rounds the whole scene's gsum once.
//
// Bound on this card: operations. 4,717,056 MAC per point for the 8x512
// decoder (forward 1,573,376, dgrad 1,570,304, wgrad 1,573,376), so one
// 64 x 16,384-point step is 9.89 TFLOP: 10.0 ms at 989 TFLOP/s bf16. Per
// launch of the launch sequence below, a forward or dgrad GEMM at 2^20 x
// 512 x 512 is bound by bytes instead: the forward reads h and writes h'
// and its keep bits (2.21 GB, 0.661 ms at 3.35 TB/s), the dgrad reads g
// and the keep bits of h_prev and writes g' and its column partials (2.23
// GB, 0.666 ms), against 0.556 ms of products.
//
// The TPU keeps a tile's nine layers of activations in VMEM (2.1 MB) and
// accumulates dW in VMEM over a sequential grid; an SM has 227 KB and
// blocks run concurrently. So the pass is a sequence of launches:
//   * the forward and dgrad GEMMs: one Hopper GEMM engine (tn_gemm_kernel)
//     with two epilogues, described below;
//   * the wgrad GEMM (mn_wgrad_kernel): the same engine's ring, warps and
//     wgmma on operands read in their stored [points][cols] layout
//     (MN-major), split-K over fixed chunks of points into f32 partials,
//     described below;
//   * small CUDA-core kernels: the per-scene latent rows, layer 0 (K = 3)
//     with its keep bits, the final layer with the loss, its dgrad/wgrad
//     and the column partials of the top g, the latent gradients;
//   * a fixed-order reduction of every set of partials. No float atomics
//     anywhere, so two runs give the same bits.
//
// The forward/dgrad engine: C[M, N] = A[M, K] B[N, K]^T, both operands
// K-major (forward: A = h_{i-1}, B = W [out][in]; dgrad: A = g_i, B = W^T
// [in][out], a contiguous copy the wrapper makes per layer).
//   * Loads: 2-D TMA tensor maps (encoded on the host through the driver
//     entry point of cuTensorMapEncodeTiled, passed as __grid_constant__
//     parameters) with 128-byte swizzle, box 64 of K x the tile's rows; one
//     producer thread fills a ring of TN_STAGES mbarrier-guarded stages
//     (A 128 x 64 and B BN x 64, 48 KB at BN = 256).
//   * Products: wgmma m64nBNk16 bf16 -> f32 from the swizzled tiles
//     (descriptor mode 128B swizzle, csrc/sm90.cuh), two consumer
//     warpgroups of 64 rows each (setmaxnreg 232 / 40 for the producer's
//     warpgroup).
//   * Schedule: one persistent CTA per SM walks 128 x BN output tiles (BN
//     256, or 128 for a width that is not a multiple of 256), N fastest,
//     so the CTAs working at once share A's rows through L2. Both
//     warpgroups work on one tile (cooperative); while they run a tile's
//     epilogue the producer already fills the ring with the next tile's
//     stages and the previous tile's TMA store drains, so the loads and
//     stores, not the products, overlap the epilogue. (Warpgroups on
//     separate tiles would each stream their own B: twice the L2 traffic
//     at K = 512.)
//   * Epilogues through shared memory: wgmma's accumulator holds, per
//     warp w of the warpgroup, rows 16w + lane/4 (+8) and columns 8j + 2
//     (lane % 4) (+1), the m16n8 C fragment of mma.sync repeated over
//     BN/8. Forward: bias row per scene (read a few column blocks ahead,
//     with the uniform choices hoisted out of the loop so it schedules as
//     one block), the skip layer's xyz term, relu, Philox dropout, and the
//     keep bits of the rounded result; dgrad: the mask from the keep bits
//     of h_prev, scale. Each warpgroup writes its 64 x BN bf16 result into
//     an output tile in the 128-byte swizzle layout (conflict-free), and
//     one thread stores it with TMA (boxes of 64 x 64). Written straight
//     from registers, 16 bytes per row and instruction, the output took
//     over twice as long.
//   * Keep bits (ops/train_gemm.py keep_bit): the mask the dgrad needs is
//     h_prev > 0, which the TPU kernel reads from activations in VMEM; read
//     from HBM, h_prev was a third of the dgrad's bytes. So the forward
//     epilogue that rounds h also writes one bit per element, bf16(h) > 0,
//     in a tile-native layout: each engine thread's BN/2 accumulators are
//     BN/64 consecutive words, threads in (tile, warpgroup, warp, lane)
//     order; word w holds column blocks j = 8 w .. 8 w + 7, block j's
//     (r0, c), (r1, c), (r0, c + 1), (r1, c + 1) at bits j % 8 + 0, 8,
//     16, 24 (keep_flags: two halves' flags from three integer ops on the
//     packed pair, shifted into place; float compares and single-bit
//     inserts cost the forward ~0.13 ms a 2^20 x 512 launch). The dgrad of
//     the next layer tiles the same [points, width] matrix with the same
//     BN, so each thread reads its own 16 bytes (BN 256) before its
//     products, and writes or reads them with no exchange between lanes.
//     The forward stages a warpgroup's words in shared memory (the
//     dgrad's column-partial buffers, unused by the forward) and its
//     leader stores them with one bulk copy beside the tile's TMA store:
//     stored by each thread from registers, the words cost ~0.12 ms a
//     2^20 x 512 launch, as the leader's next mbarrier arrive (release)
//     waited for its own store to complete.
//   * Column partials (dgrad): the backward needs per-scene column sums of
//     every g (db, gsum for dz and dW_z, the bf16(xyz)-weighted sums for
//     dW_x at layer 0 and the skip layer). After the TMA store is issued,
//     each thread of a warpgroup sums a column pair of the stored bf16
//     tile over its rows, read back from shared memory (a warp reads one
//     128-byte row: conflict-free); the two warpgroups' sums are added in
//     row order through a double-buffered shared array behind one barrier
//     of both, and written as one f32 row per 128-row tile (three more
//     rows, xyz-weighted, where the caller passes xyz). Fixed order, no
//     atomics. P is a multiple of 128, so a tile lies in one scene.
//   * Dropout: lanes q and q^1 of a quad share a 4-column Philox block of
//     a row, so lane q computes the block of row r (q even) or r + 8 (q
//     odd) and the pair swaps the two words the other needs with
//     __shfl_xor_sync: one Philox call per 4 elements. The draws run in
//     the epilogue, after the products (tools/train_gemm_probe.py times
//     the forward with and without them). Drawn between each k step's
//     wgmmas and the wait for them they were no faster, and drawn by the
//     producer warpgroup's three idle warps they were slower: three warps
//     cannot issue a tile's ~8,000 Philox blocks within its products.
//   * Deterministic: no atomics, fixed tile order within a tile's K loop.
// Shape rules (the wrapper checks and raises): M a multiple of 128, K of
// 64, N of BN, operands and keep bits 16-byte aligned.
//
// The wgrad GEMM: part[c][M][N] = sum over the points p of chunk c of
// g[p][m] h[p][n], i.e. dW = g^T h split over K = the points, from g
// [points][out] and h_{i-1} [points][in] as the pass stores them (a
// transposed copy would cost ~0.6 ms a layer).
//   * Loads: TMA boxes of 64 columns (128 bytes) x 64 points with 128-byte
//     swizzle, by the forward's tile_map: a stage holds g's 2 boxes (128
//     out columns) and h's BN/64 boxes (48 KB at BN = 256), WG_STAGES
//     stages. Both operands are MN-major in shared memory (the points, K,
//     run down the rows), so wgmma reads them with the transpose bits set
//     through desc_sw128_mn (csrc/sm90.cuh): 8-point groups 1024 bytes
//     apart (SBO), 64-column atoms one box (8 KB) apart (LBO); a k16 step
//     starts 16 points (2 KB) on.
//   * Products: as the engine's, two consumer warpgroups of 64 out rows
//     each, wgmma m64nBNk16, one producer thread, setmaxnreg 232 / 40.
//   * Schedule: a work unit is (output tile of 128 x BN, chunk of k_split
//     points); chunk boundaries come from the caller's k_split alone, never
//     from the grid. One persistent CTA per SM walks units u = blockIdx.x,
//     + gridDim.x, ..., tile fastest and chunk slowest, so the CTAs running
//     at once are on few chunks and share their g and h rows through L2.
//   * Epilogue: each unit's f32 partial goes straight from the registers
//     to part[c] (8-byte stores of the accumulator's column pairs; the
//     partials are ~3% of a launch's bytes), in full: no atomics, so the
//     result does not depend on the grid and two launches give the same
//     bits. The caller sums the chunks in a fixed order.
//   * Bound at 2^20 points x 512 x 512: reading g and h (2 GiB) and writing
//     64 chunks' partials (64 MiB) take 0.661 ms at 3.35 TB/s, the products
//     0.556 ms at 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cuda.h>   // CUtensorMap and the encoder's types; no -lcuda

#include "philox.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ primitives

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

enum Epilogue { EPI_FWD = 0, EPI_DGRAD = 1 };

// ------------------------------------------- forward / dgrad GEMM engine
//
// C[M, N] = A[M, K] B[N, K]^T, both operands K-major, through TMA and
// wgmma (see the header); the forward or dgrad epilogue on C.

using namespace sm90;

constexpr int TN_WGS = 2;                // consumer warpgroups, 64 rows each
constexpr int TN_BM = 64 * TN_WGS;       // tile rows
constexpr int TN_BK = 64;                // K per ring stage: one 128-byte row
constexpr int TN_MAX_BN = 256;
constexpr int TN_STAGES = 3;
constexpr int TN_A_BYTES = TN_BM * TN_BK * 2;               // 16 KB
constexpr int TN_STAGE_BYTES = TN_A_BYTES + TN_MAX_BN * TN_BK * 2;  // 48 KB
constexpr int TN_BOX = 64;               // output box: 64 rows x 64 columns
constexpr int TN_BOX_BYTES = TN_BOX * TN_BOX * 2;           // 8 KB
constexpr int TN_OUT_BYTES = TN_BM * TN_MAX_BN * 2;         // 64 KB
constexpr int TN_THREADS = 128 * (TN_WGS + 1);   // and the producer's warpgroup
constexpr int TN_PRODUCER_REGS = 40;     // setmaxnreg: 128 x 40 +
constexpr int TN_CONSUMER_REGS = 232;    //   256 x 232 <= 65,536
// the dgrad's column partials in shared memory, per buffer: a float2 for
// each of the 128 column-pair threads of each warpgroup and each of up
// to 4 sums (two buffers, alternating tiles)
constexpr int TN_CSUMS = 4;
constexpr int TN_CBUF_BYTES = TN_WGS * 128 * TN_CSUMS * 8;  // 8 KB
// the ring, the output tile, the two column-partial buffers, the ring's
// full and empty barriers, and slack to align the ring to 1024
constexpr int TN_SMEM = TN_STAGES * TN_STAGE_BYTES + TN_OUT_BYTES +
                        2 * TN_CBUF_BYTES + 2 * TN_STAGES * 8 + 1024;

struct TnArgs {
  int m, n, k;
  // forward epilogue
  const float* rows;          // bias row: rows[(row / p) * rows_stride + col]
  long long rows_stride;      // 0: one row shared by all points
  long long p;                // points per scene, a multiple of TN_BM: a
                              // tile's rows share one bias row
  const bf16* xyz;            // [m][3] bf16 or null (skip layer only)
  const bf16* wx;             // [n][3] bf16
  uint32_t key, threshold;
  int drop;
  float scale;                // 1/(1-rate) (forward, dgrad) or 1
  uint32_t* keep;             // keep bits: forward writes them (or null),
                              // dgrad reads them
  float* part;                // dgrad: column partials [m / TN_BM][nsum][n]
  int nsum;                   // dgrad: 1, or 4 with the xyz-weighted sums
};

// Index of the first of the BN/64 keep words of an engine thread: lane
// `lane` of warp `warp` (0-3) of warpgroup `wg` of tile `tile`.
template <int BN>
__device__ __forceinline__ long long keep_offset(long long tile, int wg,
                                                 int warp, int lane) {
  return (((tile * TN_WGS + wg) * 4 + warp) * 32 + lane) * (BN / 64);
}

template <int BN>
__device__ __forceinline__ void load_keep(const uint32_t* src,
                                          uint32_t (&kb)[BN / 64]) {
  if constexpr (BN == 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    kb[0] = v.x, kb[1] = v.y, kb[2] = v.z, kb[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
    kb[0] = v.x, kb[1] = v.y;
  }
}

template <int BN>
__device__ __forceinline__ void stage_keep(unsigned char* dst,
                                           const uint32_t (&kb)[BN / 64]) {
  if constexpr (BN == 256)
    *reinterpret_cast<uint4*>(dst) = make_uint4(kb[0], kb[1], kb[2], kb[3]);
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(kb[0], kb[1]);
}

// shared -> global bulk copy of `bytes` (a multiple of 16; both addresses
// 16-byte aligned) in the thread's bulk group, as the TMA stores
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 > 0 of both halves of a packed pair, as bits 15 (lo) and 31 (hi):
// a half is > 0 iff its sign is clear and its magnitude bits are not all
// 0 (adding 0x7fff then carries into its top bit, never into the other
// half). The predicate the dgrad used to test on h_prev, for every value
// but NaN, which the forward never stores (fmaxf(NaN, 0) is 0).
__device__ __forceinline__ uint32_t keep_flags(uint32_t s) {
  return ((s & 0x7fff7fffu) + 0x7fff7fffu) & ~s & 0x80008000u;
}

// The keep bits of column block j (4 bits: (r0, col), (r0, col + 1), (r0
// + 8, col), (r0 + 8, col + 1)): lane q draws the Philox block of row r0
// (q even) or r0 + 8 (q odd), group col >> 2, and the pair q, q^1 swaps
// the two words the other needs (words 0-1 are the even lane's columns,
// 2-3 the odd one's): one Philox draw per 4 elements.
__device__ __forceinline__ uint32_t keep_nibble(int j, long long my_row,
                                                int n0, int q, bool odd,
                                                const TnArgs& p) {
  const uint4 bits = philox::dropout_bits(
      my_row, static_cast<uint32_t>((n0 + 8 * j + 2 * q) >> 2), p.key);
  const uint32_t s0 = odd ? bits.x : bits.z, s1 = odd ? bits.y : bits.w;
  const uint32_t t0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const uint32_t t1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  return static_cast<uint32_t>((odd ? t0 : bits.x) >= p.threshold) |
         static_cast<uint32_t>((odd ? t1 : bits.y) >= p.threshold) << 1 |
         static_cast<uint32_t>((odd ? bits.z : t0) >= p.threshold) << 2 |
         static_cast<uint32_t>((odd ? bits.w : t1) >= p.threshold) << 3;
}

// The forward epilogue's columns for rows r0, r1: the tile's bias row b
// (read TN_CHUNK column blocks ahead of their use), the skip layer's xyz
// term, relu, dropout; into the output tile through word(j), and the keep
// bits of the stored values into kb.
constexpr int TN_CHUNK = 4;

template <int BN, bool DROP, bool XYZ, typename Word>
__device__ __forceinline__ void fwd_columns(const float (&acc)[BN / 2],
                                            const TnArgs& p, Word word,
                                            uint32_t (&kb)[BN / 64],
                                            const float* b, long long r0,
                                            long long r1, int n0, int q) {
#pragma unroll
  for (int i = 0; i < BN / 64; ++i) kb[i] = 0u;
  float x0[3] = {0.f, 0.f, 0.f}, x1[3] = {0.f, 0.f, 0.f};
  if (XYZ) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x0[c] = __bfloat162float(p.xyz[r0 * 3 + c]);
      x1[c] = __bfloat162float(p.xyz[r1 * 3 + c]);
    }
  }
  const bool odd = q & 1;
  const long long my_row = odd ? r1 : r0;   // the Philox block this lane draws
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += TN_CHUNK) {
    float2 c[TN_CHUNK];
#pragma unroll
    for (int u = 0; u < TN_CHUNK; ++u)
      c[u] = __ldg(reinterpret_cast<const float2*>(b + 8 * (j0 + u)));
#pragma unroll
    for (int u = 0; u < TN_CHUNK; ++u) {
      const int j = j0 + u;
      float v00 = acc[4 * j] + c[u].x, v01 = acc[4 * j + 1] + c[u].y;
      float v10 = acc[4 * j + 2] + c[u].x, v11 = acc[4 * j + 3] + c[u].y;
      if (XYZ) {
        const bf16* w = p.wx + (n0 + 8 * j + 2 * q) * 3;
        const float w0 = __bfloat162float(w[0]), w1 = __bfloat162float(w[1]),
                    w2 = __bfloat162float(w[2]), w3 = __bfloat162float(w[3]),
                    w4 = __bfloat162float(w[4]), w5 = __bfloat162float(w[5]);
        v00 += x0[0] * w0 + x0[1] * w1 + x0[2] * w2;
        v01 += x0[0] * w3 + x0[1] * w4 + x0[2] * w5;
        v10 += x1[0] * w0 + x1[1] * w1 + x1[2] * w2;
        v11 += x1[0] * w3 + x1[1] * w4 + x1[2] * w5;
      }
      v00 = fmaxf(v00, 0.f);
      v01 = fmaxf(v01, 0.f);
      v10 = fmaxf(v10, 0.f);
      v11 = fmaxf(v11, 0.f);
      if (DROP) {
        const uint32_t nib = keep_nibble(j, my_row, n0, q, odd, p);
        v00 = nib & 1u ? v00 * p.scale : 0.f;
        v01 = nib & 2u ? v01 * p.scale : 0.f;
        v10 = nib & 4u ? v10 * p.scale : 0.f;
        v11 = nib & 8u ? v11 * p.scale : 0.f;
      }
      const uint32_t s0 = pack_bf16(v00, v01), s1 = pack_bf16(v10, v11);
      uint32_t* w = word(j);
      w[0] = s0;
      w[8 * 128 / 4] = s1;
      kb[j / 8] |= keep_flags(s0) >> (15 - j % 8) |
                   keep_flags(s1) >> (7 - j % 8);
    }
  }
}

// One warp's rows r0 = row0 + lane/4 and r1 = r0 + 8 of the tile, columns
// n0 + 8j + 2 (lane % 4) (+1), from the accumulator into the warpgroup's
// output tile in shared memory: BN/64 boxes of 64 x 64 in the 128-byte
// swizzle layout the TMA store reads (16-byte chunk c of row r at c ^ (r %
// 8): a warp's 8 rows x 16 bytes hit 32 distinct banks). kb: the thread's
// keep bits, written by the forward, read by the dgrad.
template <int BN, int EPI>
__device__ __forceinline__ void tn_epilogue(const float (&acc)[BN / 2],
                                            const TnArgs& p,
                                            unsigned char* obuf,
                                            uint32_t (&kb)[BN / 64], int row0,
                                            int n0, int wrow, int lane) {
  const int q = lane % 4, g = lane / 4;
  const long long r0 = row0 + g, r1 = r0 + 8;
  // (row wrow + g, column 8j + 2q) is at base + box + chunk; plain C++
  // shared-memory accesses, which the compiler may schedule around loads
  unsigned char* base = obuf + (wrow + g) * 128 + 4 * q;
  auto word = [&](int j) {
    return reinterpret_cast<uint32_t*>(base + (j / 8) * TN_BOX_BYTES +
                                       (((j % 8) ^ g) << 4));
  };
  if (EPI == EPI_FWD) {
    const float* b = p.rows + (r0 / p.p) * p.rows_stride + n0 + 2 * q;
    // the uniform choices out of the loop, so that its iterations form
    // one block the compiler can schedule (loads ahead of their use)
    if (p.drop) {
      if (p.xyz != nullptr)
        fwd_columns<BN, true, true>(acc, p, word, kb, b, r0, r1, n0, q);
      else
        fwd_columns<BN, true, false>(acc, p, word, kb, b, r0, r1, n0, q);
    } else {
      if (p.xyz != nullptr)
        fwd_columns<BN, false, true>(acc, p, word, kb, b, r0, r1, n0, q);
      else
        fwd_columns<BN, false, false>(acc, p, word, kb, b, r0, r1, n0, q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t k = kb[j / 8] >> (j % 8);
      uint32_t* w = word(j);
      w[0] = pack_bf16(k & 1u ? acc[4 * j] * p.scale : 0.f,
                       k & 1u << 16 ? acc[4 * j + 1] * p.scale : 0.f);
      w[8 * 128 / 4] = pack_bf16(k & 1u << 8 ? acc[4 * j + 2] * p.scale : 0.f,
                                 k & 1u << 24 ? acc[4 * j + 3] * p.scale : 0.f);
    }
  }
}

// The dgrad's column sums of a warpgroup's 64 x BN output tile, as stored
// (bf16), read back from shared memory: thread t (0-127) sums column pair
// t % (BN/2) over rows seg * RS .. seg * RS + RS - 1 in order (seg = t /
// (BN/2), RS = 64 / (256 / BN)), with the three bf16(xyz)-weighted sums if
// XYZ, into slot wg * SEG + seg of the column-partial buffer cbuf
// ([slot][sum][pair] float2).
template <int BN, bool XYZ>
__device__ __forceinline__ void dgrad_column_sums(const unsigned char* obuf,
                                             float2* cbuf, const TnArgs& p,
                                             long long wm0, int wg, int t) {
  constexpr int PAIRS = BN / 2, SEG = 128 / PAIRS, RS = TN_BOX / SEG;
  const int pr = t % PAIRS, seg = t / PAIRS;
  // pair pr: 4-byte word pr % 4 of 16-byte chunk (pr % 32) / 4 of box pr / 32
  const unsigned char* col =
      obuf + (pr / 32) * TN_BOX_BYTES + 4 * (pr % 4);
  const int chunk = (pr % 32) / 4;
  float2 s[TN_CSUMS];
#pragma unroll
  for (int c = 0; c < TN_CSUMS; ++c) s[c] = make_float2(0.f, 0.f);
#pragma unroll 8
  for (int r = seg * RS; r < seg * RS + RS; ++r) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        col + r * 128 + ((chunk ^ (r % 8)) << 4));
    const float lo = __uint_as_float(v << 16);
    const float hi = __uint_as_float(v & 0xffff0000u);
    s[0].x += lo;
    s[0].y += hi;
    if (XYZ) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float x = __bfloat162float(p.xyz[(wm0 + r) * 3 + c]);
        s[1 + c].x += x * lo;
        s[1 + c].y += x * hi;
      }
    }
  }
  float2* dst = cbuf + (wg * SEG + seg) * TN_CSUMS * PAIRS + pr;
#pragma unroll
  for (int c = 0; c < (XYZ ? TN_CSUMS : 1); ++c) dst[c * PAIRS] = s[c];
}

// Both warpgroups' column partials of a tile (cbuf, after a barrier of
// both), added in row order and written as the tile's rows of p.part by
// warps 1-3 of each warpgroup (thread t = 0 .. 96 TN_WGS - 1 takes
// outputs t, t + 96 TN_WGS, ...): warp 0 holds the leader, whose next
// mbarrier arrive (release) would wait for its stores to complete.
template <int BN>
__device__ __forceinline__ void dgrad_column_sums_out(const float2* cbuf,
                                                 const TnArgs& p, int m0,
                                                 int n0, int t) {
  constexpr int PAIRS = BN / 2, SLOTS = TN_WGS * (128 / PAIRS);
  float* row = p.part + static_cast<long long>(m0 / TN_BM) * p.nsum * p.n;
  for (int o = t; o < p.nsum * PAIRS; o += 96 * TN_WGS) {
    const int c = o / PAIRS, pr = o % PAIRS;
    float2 a = cbuf[c * PAIRS + pr];
#pragma unroll
    for (int k = 1; k < SLOTS; ++k) {
      const float2 b = cbuf[(k * TN_CSUMS + c) * PAIRS + pr];
      a.x += b.x;
      a.y += b.y;
    }
    *reinterpret_cast<float2*>(row + static_cast<long long>(c) * p.n + n0 +
                               2 * pr) = a;
  }
}

template <int BN, int EPI>
__global__ void __launch_bounds__(TN_THREADS, 1)
    tn_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_o,
                   const TnArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t out = ring + TN_STAGES * TN_STAGE_BYTES;
  const uint32_t cbufs = out + TN_OUT_BYTES;
  const uint32_t full = cbufs + 2 * TN_CBUF_BYTES;
  const uint32_t empty = full + TN_STAGES * 8;
  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform to the compiler (no divergent path around the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_tiles = p.n / BN;
  const int tiles = (p.m / TN_BM) * n_tiles;
  const int ksteps = p.k / TN_BK;
  if (tid == 0) {
    for (int s = 0; s < TN_STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, TN_WGS);     // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * TN_WGS) {
    // producer: every K stage of every tile of this CTA (one thread)
    setmaxnreg_dec<TN_PRODUCER_REGS>();
    if (warp == 4 * TN_WGS && lane == 0) {
      tma_prefetch_map(&map_a);
      tma_prefetch_map(&map_b);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / n_tiles) * TN_BM, n0 = (t % n_tiles) * BN;
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(empty + stage * 8, phase ^ 1u);
          const uint32_t f = full + stage * 8;
          const uint32_t s = ring + stage * TN_STAGE_BYTES;
          mbar_expect_tx(f, (TN_BM + BN) * TN_BK * 2);
          tma_load_2d(s, &map_a, kb * TN_BK, m0, f);
          tma_load_2d(s + TN_A_BYTES, &map_b, kb * TN_BK, n0, f);
          if (++stage == TN_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
    // and its 64 x BN part of the output tile in shared memory
    setmaxnreg_inc<TN_CONSUMER_REGS>();
    const int wg = warp / 4;
    const uint32_t leader = (tid % 128) == 0;
    const uint32_t obuf = out + wg * TN_BOX * TN_MAX_BN * 2;
    unsigned char* obuf_p = smem_raw + (obuf - smem_u32(smem_raw));
    float2* cbuf_p =
        reinterpret_cast<float2*>(smem_raw + (cbufs - smem_u32(smem_raw)));
    int stage = 0, parity = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    uint32_t kbits[BN / 64];
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / n_tiles) * TN_BM, n0 = (t % n_tiles) * BN;
      const int wm0 = m0 + wg * TN_BOX;
      // the dgrad's keep bits of h_prev, loaded under the products
      if (EPI == EPI_DGRAD)
        load_keep<BN>(p.keep + keep_offset<BN>(t, wg, warp % 4, lane), kbits);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < ksteps; ++kb) {
        mbar_wait(full + stage * 8, phase);
        wgmma_fence();
        const uint32_t a = ring + stage * TN_STAGE_BYTES + wg * 64 * 128;
        const uint32_t b = ring + stage * TN_STAGE_BYTES + TN_A_BYTES;
#pragma unroll
        for (int kk = 0; kk < TN_BK / 16; ++kk)
          Wgmma<BN>::run(acc, desc_sw128(a + 32 * kk),
                         desc_sw128(b + 32 * kk));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + prev * 8, leader);
        }
        prev = stage;
        if (++stage == TN_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      mbar_arrive(empty + prev * 8, leader);
      // the previous store has read the output tile, and (dgrad) every
      // thread of the warpgroup has summed its columns
      if (leader) bulk_wait_read<0>();
      named_sync(2 + wg, 128);
      tn_epilogue<BN, EPI>(acc, p, obuf_p, kbits, wm0 + 16 * (warp % 4), n0,
                           16 * (warp % 4), lane);
      // the forward's keep words, in thread order for one bulk store
      const uint32_t kstage = cbufs + wg * 128 * (BN / 16);
      if (EPI == EPI_FWD && p.keep != nullptr)
        stage_keep<BN>(smem_raw + (kstage - smem_u32(smem_raw)) +
                           (tid % 128) * (BN / 16),
                       kbits);
      fence_async_smem();                  // the tile, visible to the TMA store
      named_sync(2 + wg, 128);
      if (leader) {
#pragma unroll
        for (int b = 0; b < BN / TN_BOX; ++b)
          tma_store_2d(&map_o, obuf + b * TN_BOX_BYTES, n0 + b * TN_BOX, wm0);
        if (EPI == EPI_FWD && p.keep != nullptr)
          bulk_store(p.keep + keep_offset<BN>(t, wg, 0, 0), kstage,
                     128 * (BN / 16));
        bulk_commit();
      }
      if (EPI == EPI_DGRAD) {
        // column partials: this buffer was last read two tiles ago, before
        // the barrier of the previous tile
        float2* cbuf = cbuf_p + parity * (TN_CBUF_BYTES / 8);
        if (p.nsum == TN_CSUMS)
          dgrad_column_sums<BN, true>(obuf_p, cbuf, p, wm0, wg, tid % 128);
        else
          dgrad_column_sums<BN, false>(obuf_p, cbuf, p, wm0, wg, tid % 128);
        named_sync(1, 128 * TN_WGS);       // both warpgroups' sums
        if (warp % 4 != 0)
          dgrad_column_sums_out<BN>(cbuf, p, m0, n0,
                                    96 * wg + 32 * (warp % 4 - 1) + lane);
        parity ^= 1;
      }
    }
    if (leader) bulk_wait_read<0>();       // shared memory outlives the store
  }
}

// ------------------------------------------------ wgrad GEMM (MN-major)
//
// part[c][M][N] = sum over chunk c's points of g[p][m] h[p][n] (see the
// header): the engine's warps and ring, operands MN-major.

constexpr int WG_BK = 64;                // points per ring stage
constexpr int WG_STAGES = 4;
constexpr int WG_BOX = 64;               // box: 64 columns (128 B) x WG_BK
                                         // points
constexpr int WG_BOX_BYTES = WG_BOX * WG_BK * 2;              // 8 KB
constexpr int WG_A_BYTES = (TN_BM / WG_BOX) * WG_BOX_BYTES;   // 16 KB
constexpr int WG_STAGE_BYTES =                                 // 48 KB
    WG_A_BYTES + (TN_MAX_BN / WG_BOX) * WG_BOX_BYTES;
constexpr int WG_K16_BYTES = 16 * 128;   // a k16 step: 16 points
// the ring, its full and empty barriers, slack to align it to 1024
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 2 * WG_STAGES * 8 + 1024;

struct WgradArgs {
  int m, n;                   // out and in widths
  int k_split;                // points per chunk
  int units;                  // tiles x chunks
  float* part;                // [chunks][m][n]
};

template <int BN>
__global__ void __launch_bounds__(TN_THREADS, 1)
    mn_wgrad_kernel(const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_h,
                    const WgradArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = ring + WG_STAGES * WG_STAGE_BYTES;
  const uint32_t empty = full + WG_STAGES * 8;
  const int tid = threadIdx.x, lane = tid % 32;
  // warp-uniform to the compiler (no divergent path around the wgmmas)
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int n_tiles = p.n / BN;
  const int tiles = (p.m / TN_BM) * n_tiles;
  const int ksteps = p.k_split / WG_BK;
  if (tid == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, TN_WGS);   // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * TN_WGS) {
    // producer: every stage of every unit of this CTA (one thread)
    setmaxnreg_dec<TN_PRODUCER_REGS>();
    if (warp == 4 * TN_WGS && lane == 0) {
      tma_prefetch_map(&map_g);
      tma_prefetch_map(&map_h);
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const int t = u % tiles;
        const int m0 = (t / n_tiles) * TN_BM, n0 = (t % n_tiles) * BN;
        const int k0 = (u / tiles) * p.k_split;
        for (int kb = 0; kb < ksteps; ++kb) {
          mbar_wait(empty + stage * 8, phase ^ 1u);
          const uint32_t f = full + stage * 8;
          const uint32_t s = ring + stage * WG_STAGE_BYTES;
          const int pt = k0 + kb * WG_BK;
          mbar_expect_tx(f, (TN_BM + BN) * WG_BK * 2);
#pragma unroll
          for (int b = 0; b < TN_BM / WG_BOX; ++b)
            tma_load_2d(s + b * WG_BOX_BYTES, &map_g, m0 + b * WG_BOX, pt, f);
#pragma unroll
          for (int b = 0; b < BN / WG_BOX; ++b)
            tma_load_2d(s + WG_A_BYTES + b * WG_BOX_BYTES, &map_h,
                        n0 + b * WG_BOX, pt, f);
          if (++stage == WG_STAGES) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns out rows 64 wg .. 64 wg + 63 of each
    // tile, which are g's box wg of every stage
    setmaxnreg_inc<TN_CONSUMER_REGS>();
    const int wg = warp / 4;
    const uint32_t leader = (tid % 128) == 0;
    int stage = 0;
    uint32_t phase = 0;
    float acc[BN / 2];
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int t = u % tiles;
      const int m0 = (t / n_tiles) * TN_BM, n0 = (t % n_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < ksteps; ++kb) {
        mbar_wait(full + stage * 8, phase);
        wgmma_fence();
        const uint32_t a = ring + stage * WG_STAGE_BYTES + wg * WG_BOX_BYTES;
        const uint32_t b = ring + stage * WG_STAGE_BYTES + WG_A_BYTES;
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk)
          Wgmma<BN, 1>::run(
              acc, desc_sw128_mn(a + WG_K16_BYTES * kk, WG_BOX_BYTES),
              desc_sw128_mn(b + WG_K16_BYTES * kk, WG_BOX_BYTES));
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          mbar_arrive(empty + prev * 8, leader);
        }
        prev = stage;
        if (++stage == WG_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(acc[i])::"memory");
      mbar_arrive(empty + prev * 8, leader);
      // accumulator 4j + e: row 16 (warp % 4) + lane / 4 (+8 for e >= 2),
      // column 8j + 2 (lane % 4) (+1 for odd e)
      const long long row = m0 + TN_BOX * wg + 16 * (warp % 4) + lane / 4;
      float* out = p.part + ((long long)(u / tiles) * p.m + row) * p.n + n0 +
                   2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(out + 8 * j) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(out + 8LL * p.n + 8 * j) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// The map of a row-major [rows][cols] bf16 matrix: box box_cols (64: one
// 128-byte row) x box_rows, 128-byte swizzle. False if the encoder is
// missing or refuses.
bool tile_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <int BN, int EPI>
int launch_tn(const void* a, const void* b, void* out, const TnArgs& p,
              cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        tn_gemm_kernel<BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TN_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  CUtensorMap ma, mb, mo;
  if (!tile_map(&ma, a, p.m, p.k, TN_BK, TN_BM) ||
      !tile_map(&mb, b, p.n, p.k, TN_BK, BN) ||
      !tile_map(&mo, out, p.m, p.n, TN_BOX, TN_BOX))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int tiles = (p.m / TN_BM) * (p.n / BN);
  tn_gemm_kernel<BN, EPI><<<tiles < sms ? tiles : sms, TN_THREADS, TN_SMEM,
                            stream>>>(ma, mb, mo, p);
  return static_cast<int>(cudaGetLastError());
}

// A [m][k] and B [n][k] into out [m][n], all row-major, contiguous and
// 16-byte aligned, as are the keep bits (and, for dgrad, the partials).
template <int EPI>
int run_tn(const void* a, const void* b, void* out, int bn, const TnArgs& p,
           void* stream) {
  if (p.m <= 0 || p.n <= 0 || p.k <= 0 || p.m % TN_BM || p.k % TN_BK ||
      (bn != 128 && bn != TN_MAX_BN) || p.n % bn ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(p.keep) % 16 ||
      reinterpret_cast<uintptr_t>(p.part) % 16 ||
      (EPI == EPI_DGRAD &&
       (p.keep == nullptr || p.part == nullptr ||
        (p.nsum != 1 && p.nsum != TN_CSUMS) ||
        (p.nsum == TN_CSUMS && p.xyz == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == TN_MAX_BN ? launch_tn<TN_MAX_BN, EPI>(a, b, out, p, s)
                         : launch_tn<128, EPI>(a, b, out, p, s);
}

template <int BN>
int launch_wgrad(const void* g, const void* h, const WgradArgs& p, int k,
                 cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mn_wgrad_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WG_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  CUtensorMap mg, mh;
  if (!tile_map(&mg, g, k, p.m, WG_BOX, WG_BK) ||
      !tile_map(&mh, h, k, p.n, WG_BOX, WG_BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  mn_wgrad_kernel<BN><<<p.units < sms ? p.units : sms, TN_THREADS, WG_SMEM,
                        stream>>>(mg, mh, p);
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

// Layer 0 (K = 3 on CUDA cores) for a band of L0_ROWS rows, one engine
// warp's rows of a tile: h[m][4g..4g+3] from the scene's row, xyz, relu and
// dropout, one Philox call per 4 columns; then, if keep is set, the band's
// keep bits in the engine's layout (keep_offset, tile width bn) through
// one byte per element in shared memory ([L0_ROWS][width]).
constexpr int L0_ROWS = 16;

__global__ void __launch_bounds__(SMALL_THREADS)
    layer0_kernel(const bf16* __restrict__ xyz, const float* __restrict__ rows,
                  const bf16* __restrict__ wx, bf16* __restrict__ h,
                  uint32_t* __restrict__ keep, long long p, int width, int bn,
                  uint32_t key, uint32_t threshold, float scale, int drop) {
  extern __shared__ unsigned char pos[];
  const int groups = width / 4;
  const long long m0 = (long long)blockIdx.x * L0_ROWS;
  for (int it = threadIdx.x; it < L0_ROWS * groups; it += SMALL_THREADS) {
    const int r = it / groups, gi = it % groups;
    const long long m = m0 + r;
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
      pos[r * width + col] = __bfloat162float(o[j]) > 0.f;
    }
    *reinterpret_cast<uint2*>(h + m * width + gi * 4) =
        *reinterpret_cast<const uint2*>(o);
  }
  if (keep == nullptr) return;
  __syncthreads();
  // word w of lane (g, q) of engine warp band (m0 % TN_BM) / 16 of tile
  // (m0 / TN_BM, nb): bit b is row g (+8 if b / 8 is odd), column 8 j + 2
  // q (+1 if b >= 16) of that tile, j = 8 w + b % 8
  const int wpt = bn / 64, per_tile = 32 * wpt;
  const long long band = (m0 / TN_BM) * (width / bn) * (TN_WGS * 4) +
                         (m0 % TN_BM) / L0_ROWS;
  for (int wi = threadIdx.x; wi < width / 2; wi += SMALL_THREADS) {
    const int nb = wi / per_tile, lane = (wi % per_tile) / wpt, w = wi % wpt;
    const unsigned char* src = pos + (lane / 4) * width + nb * bn +
                               64 * w + 2 * (lane % 4);
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 32; ++b)
      word |= static_cast<uint32_t>(
                  src[(b / 8) % 2 * 8 * width + 8 * (b % 8) + b / 16])
              << b;
    keep[((band + nb * TN_WGS * 4) * 32 + lane) * wpt + w] = word;
  }
}

// Final layer, loss, dpred, and the final layer's backward, for a tile of
// FINAL_TILE points: pred = h . w + b; loss_part = sum |diff|; g_last =
// bf16(dpred); g_out = bf16(where(h > 0, g_last * w * scale, 0));
// dw_part = sum_t g_last h; db_part = sum_t g_last; col_part = the
// tile's column sums of g_out as stored (bf16), and with xyz (not null)
// the three bf16(xyz)-weighted sums: [tile][1 or 4][k_width].
constexpr int FINAL_TILE = 64;

__global__ void __launch_bounds__(SMALL_THREADS)
    final_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                 const float* __restrict__ b, const float* __restrict__ sdf,
                 const bf16* __restrict__ xyz, bf16* __restrict__ g_out,
                 float* __restrict__ loss_part, float* __restrict__ dw_part,
                 float* __restrict__ db_part, float* __restrict__ col_part,
                 int k_width, float clamp, float inv_n, float scale) {
  __shared__ float gs[FINAL_TILE];
  __shared__ float red[SMALL_THREADS / 32];
  __shared__ float xs[FINAL_TILE * 3];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * FINAL_TILE;
  if (xyz != nullptr)
    for (int i = tid; i < FINAL_TILE * 3; i += SMALL_THREADS)
      xs[i] = __bfloat162float(xyz[m0 * 3 + i]);
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
  const int nsum = xyz != nullptr ? 4 : 1;
  for (int k = tid * 2; k < k_width; k += SMALL_THREADS * 2) {
    const float2 wk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + k));
    float d0 = 0.f, d1 = 0.f;
    float c[4][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    for (int mi = 0; mi < FINAL_TILE; ++mi) {
      const long long off = (m0 + mi) * k_width + k;
      const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(h + off));
      const float gv = gs[mi];
      d0 += gv * hv.x;
      d1 += gv * hv.y;
      const __nv_bfloat162 o = __floats2bfloat162_rn(
          hv.x > 0.f ? gv * wk.x * scale : 0.f, hv.y > 0.f ? gv * wk.y * scale : 0.f);
      *reinterpret_cast<__nv_bfloat162*>(g_out + off) = o;
      const float2 of = __bfloat1622float2(o);
      c[0][0] += of.x;
      c[0][1] += of.y;
      if (xyz != nullptr) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          c[1 + j][0] += xs[mi * 3 + j] * of.x;
          c[1 + j][1] += xs[mi * 3 + j] * of.y;
        }
      }
    }
    dw_part[(long long)blockIdx.x * k_width + k] = d0;
    dw_part[(long long)blockIdx.x * k_width + k + 1] = d1;
    float* cp = col_part + (long long)blockIdx.x * nsum * k_width + k;
    for (int j = 0; j < nsum; ++j) {
      cp[j * k_width] = c[j][0];
      cp[j * k_width + 1] = c[j][1];
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

// out[M][N] = drop(relu(h[M][K] W[N][K]^T + rows (+ xyz term))), all
// row-major and contiguous; bn (128 or 256) the tile width, N % bn == 0;
// keep (M N / 32 words, or null): the keep bits bf16(out) > 0.
int ft_gemm_fwd(const void* h, const void* w, int m, int n, int k, int bn,
                const float* rows, long long rows_stride, long long p,
                const void* xyz, const void* wx, unsigned key,
                unsigned threshold, float scale, int drop, void* out,
                void* keep, void* stream) {
  if (p <= 0 || p % TN_BM) return static_cast<int>(cudaErrorInvalidValue);
  TnArgs a{};
  a.m = m;
  a.n = n;
  a.k = k;
  a.rows = rows;
  a.rows_stride = rows_stride;
  a.p = p;
  a.xyz = static_cast<const bf16*>(xyz);
  a.wx = static_cast<const bf16*>(wx);
  a.key = key;
  a.threshold = threshold;
  a.drop = drop;
  a.scale = scale;
  a.keep = static_cast<uint32_t*>(keep);
  return run_tn<EPI_FWD>(h, w, out, bn, a, stream);
}

// g_prev[M][N] = bf16(where(keep bit of h_prev, (g[M][K] wt[N][K]^T) *
// scale, 0)), wt = W^T contiguous ([in][out]); keep as ft_gemm_fwd wrote
// it for h_prev [M][N]; part [M / 128][nsum][N]: each 128-row tile's
// column sums of g_prev, nsum = 1, or 4 with the bf16(xyz [M][3])-weighted
// sums when xyz is not null. As ft_gemm_fwd otherwise.
int ft_gemm_dgrad(const void* g, const void* wt, int m, int n, int k, int bn,
                  const void* keep, const void* xyz, float scale, void* out,
                  float* part, void* stream) {
  TnArgs a{};
  a.m = m;
  a.n = n;
  a.k = k;
  a.scale = scale;
  a.keep = static_cast<uint32_t*>(const_cast<void*>(keep));
  a.xyz = static_cast<const bf16*>(xyz);
  a.part = part;
  a.nsum = xyz != nullptr ? TN_CSUMS : 1;
  return run_tn<EPI_DGRAD>(g, wt, out, bn, a, stream);
}

// part[K / k_split][M][N] = per-chunk sums of g[K][M]^T h[K][N] (bf16 in,
// f32 out), all row-major, contiguous and 16-byte aligned; bn (128 or 256)
// the tile width, N % bn == 0, M % 128 == 0, k_split a multiple of 64
// dividing K.
int ft_gemm_wgrad(const void* g, const void* h, int m, int n, long long k,
                  long long k_split, int bn, float* part, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k > 0x7fffffffLL || m % TN_BM ||
      (bn != 128 && bn != TN_MAX_BN) || n % bn || k_split <= 0 ||
      k_split % WG_BK || k % k_split ||
      (m / TN_BM) * (long long)(n / bn) * (k / k_split) > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(g) % 16 ||
      reinterpret_cast<uintptr_t>(h) % 16 ||
      reinterpret_cast<uintptr_t>(part) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  WgradArgs a{};
  a.m = m;
  a.n = n;
  a.k_split = static_cast<int>(k_split);
  a.units =
      static_cast<int>((m / TN_BM) * (long long)(n / bn) * (k / k_split));
  a.part = part;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == TN_MAX_BN
             ? launch_wgrad<TN_MAX_BN>(g, h, a, static_cast<int>(k), s)
             : launch_wgrad<128>(g, h, a, static_cast<int>(k), s);
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

// h [n_points][width] of layer 0, and (keep not null) its keep bits in
// the engine's layout for tile width bn; n_points a multiple of TN_BM.
int ft_layer0(const void* xyz, const float* rows, const void* wx, void* h,
              void* keep, long long n_points, long long p, int width, int bn,
              unsigned key, unsigned threshold, float scale, int drop,
              void* stream) {
  if (width % 4 || p <= 0 || n_points % TN_BM ||
      (keep != nullptr && ((bn != 128 && bn != TN_MAX_BN) || width % bn)) ||
      L0_ROWS * width > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  layer0_kernel<<<static_cast<unsigned>(n_points / L0_ROWS), SMALL_THREADS,
                  L0_ROWS * width, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xyz), rows, static_cast<const bf16*>(wx),
      static_cast<bf16*>(h), static_cast<uint32_t*>(keep), p, width, bn, key,
      threshold, scale, drop);
  return last_error();
}

// col_part [n_points / FINAL_TILE][1 or 4][k_width] (4 with xyz).
int ft_final(const void* h, const void* w, const float* b, const float* sdf,
             const void* xyz, void* g_out, float* loss_part, float* dw_part,
             float* db_part, float* col_part, long long n_points, int k_width,
             float clamp, float inv_n, float scale, void* stream) {
  if (n_points % FINAL_TILE || k_width % 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_points == 0) return 0;
  final_kernel<<<static_cast<unsigned>(n_points / FINAL_TILE), SMALL_THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w), b, sdf,
      static_cast<const bf16*>(xyz), static_cast<bf16*>(g_out), loss_part,
      dw_part, db_part, col_part, k_width, clamp, inv_n, scale);
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

// Tile constants the wrapper must respect: {FINAL_TILE}.
void ft_constants(int* out) { out[0] = FINAL_TILE; }

// The forward/dgrad engine's layout (ops/train_gemm.py TN_LAYOUT): tile
// rows, K per stage, widest tile, ring stages, swizzle bytes, the
// descriptor's 8-row stride, bytes per stage, output box side, threads,
// dynamic shared memory, one column-partial buffer's bytes.
void ft_gemm_layout(int* out) {
  out[0] = TN_BM;
  out[1] = TN_BK;
  out[2] = TN_MAX_BN;
  out[3] = TN_STAGES;
  out[4] = 128;
  out[5] = static_cast<int>(sm90::SW128_SBO);
  out[6] = TN_STAGE_BYTES;
  out[7] = TN_BOX;
  out[8] = TN_THREADS;
  out[9] = TN_SMEM;
  out[10] = TN_CBUF_BYTES;
}

// The wgrad GEMM's layout (ops/train_gemm.py WGRAD_LAYOUT): tile rows,
// points per stage, widest tile, ring stages, swizzle bytes, the
// descriptor's LBO (64-column atoms) and SBO (8-point groups), bytes per
// stage, threads, dynamic shared memory.
void ft_wgrad_layout(int* out) {
  out[0] = TN_BM;
  out[1] = WG_BK;
  out[2] = TN_MAX_BN;
  out[3] = WG_STAGES;
  out[4] = 128;
  out[5] = WG_BOX_BYTES;
  out[6] = static_cast<int>(sm90::SW128_SBO);
  out[7] = WG_STAGE_BYTES;
  out[8] = TN_THREADS;
  out[9] = WG_SMEM;
}

}  // extern "C"
