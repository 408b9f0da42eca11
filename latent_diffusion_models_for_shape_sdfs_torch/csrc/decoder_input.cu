// The bf16 decoder's input and skip operands on the training route, written
// from the per-scene codes, and their cotangents reduced back to them.
//
// Replaces no TPU kernel: the JAX package broadcasts each scene's code over
// its points (jnp.broadcast_to in train/auto_decoder.py) and leaves the
// concatenations to XLA. In the port's plain form the same step materialises
// the codes as an fp32 [S P, L] tensor, casts it to bf16, concatenates it
// with xyz into lin0's input and again into the skip layer's, and in the
// backward adds the two cotangents of that input before it sums them over
// each scene's rows. These kernels never form the flat codes.
//
// Entries (z [S, L] fp32, xyz [S, P, 3] fp32, rows = S P, row r in scene
// r / P; T = L + 3 rounded up to a multiple of 8):
//   input_rows_launch    out [rows, xw + T] bf16: columns [0, xw) copied
//       from x [rows, xw] bf16 (none where xw == 0), then bf16(z[s]),
//       bf16(xyz[r]) and zeros, each value rounded to nearest even as
//       torch's cast rounds it;
//   scene_colsum_launch  from d [rows, dcols] bf16: gx = d[:, :xw] as a
//       dense [rows, xw] bf16 tensor (none where xw == 0) and
//       dz[s, c] = sum over scene s's rows of fp32(d[r, xw + c]), c < L:
//       one partial row a work item (ITEM_ROWS rows of one scene), then a
//       second launch that adds each scene's partial rows in order.
//
// Bound on this card: bytes. Each row is read and written once in 16-byte
// chunks, the writes and the reads read once marked streaming; z, xyz and
// the partials are a few MB against the rows' hundreds.
//
// Design: every access of a row is 16 bytes (8 columns), and a CTA takes
// one tile of rows or one work item.
//   input_rows_kernel: a tile of rows, each of its two parts (x's columns,
//     the tail) at most UNROLL * THREADS chunks; the CTA stages the tile's
//     xyz and scene ids in shared memory with one coalesced read; thread t
//     issues the loads of x's chunks t, t + THREADS, ..., writes the tail's
//     chunks t, t + THREADS, ... while they are in flight, then x's. Warps
//     stay on one part: no thread waits on the other part's loads.
//   scene_colsum_kernel: thread (lane, chunk) reads chunk `chunk` of the
//     item's rows lane, lane + lanes, ... (BWD_UNROLL rows' loads in flight),
//     copies it to gx or adds it in row order into its 8 column sums; the
//     CTA adds its lanes in order into the item's partial row.
//   scene_finish_kernel: a thread a (scene, column) adds the scene's partial
//     rows in order.
// No float atomics: two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_UNROLL = 4;        // forward: chunks of each part a thread
constexpr int TILE_CHUNKS = THREADS * MAX_UNROLL;  // ... and a tile, at most
constexpr int BWD_UNROLL = 8;        // backward: rows' loads in flight
constexpr int ITEM_ROWS = 128;       // backward: rows of a work item
constexpr int MAX_CHUNKS = THREADS;  // backward: a row's chunks fit one CTA

typedef __nv_bfloat16 bf16;

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);   // a in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

// Tail chunk j of a row of scene s whose xyz is p[0..2]: columns 8j .. 8j + 7
// of [bf16(z[s]) | bf16(xyz) | 0].
__device__ __forceinline__ uint4 tail_chunk(const float* __restrict__ z,
                                            const float* p, unsigned s,
                                            int L, bool zvec, int j) {
  const int c0 = 8 * j;
  float v[8];
  if (zvec && c0 + 8 <= L) {
    const float4* zp = reinterpret_cast<const float4*>(z + (size_t)s * L + c0);
    const float4 a = __ldg(zp), b = __ldg(zp + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      v[e] = c < L ? __ldg(z + (size_t)s * L + c) : c < L + 3 ? p[c - L] : 0.f;
    }
  }
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// The tile's chunks t, t + THREADS, ... of a part `chunks` wide: their row
// and column within the part, stepped without a division.
struct Walk {
  int r, k, dr, dk, chunks;
  __device__ Walk(int chunks_) : chunks(chunks_) {
    r = threadIdx.x / chunks;
    k = threadIdx.x % chunks;
    dr = THREADS / chunks;
    dk = THREADS % chunks;
  }
  __device__ void step() {
    r += dr;
    k += dk;
    if (k >= chunks) {
      k -= chunks;
      ++r;
    }
  }
};

// out[r, 8k .. 8k + 7] for every chunk k of the tile's rows: x's part (its
// loads issued first), then the tail's, then x's stores; UNROLL chunks of
// each part a thread.
template <int UNROLL>
__global__ void __launch_bounds__(THREADS)
    input_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ z,
                      const float* __restrict__ xyz, bf16* __restrict__ out,
                      unsigned rows, unsigned points, int L, bool zvec,
                      int xchunks, int chunks, int tile_rows) {
  __shared__ float sxyz[3 * THREADS * UNROLL];
  __shared__ unsigned sscene[THREADS * UNROLL];
  const unsigned r0 = blockIdx.x * tile_rows;
  const int nr = min((unsigned)tile_rows, rows - r0);
  for (int i = threadIdx.x; i < 3 * nr; i += THREADS)
    sxyz[i] = __ldcs(xyz + (size_t)r0 * 3 + i);
  for (int i = threadIdx.x; i < nr; i += THREADS) sscene[i] = (r0 + i) / points;
  bf16* o = out + (size_t)r0 * chunks * 8;
  uint4 q[UNROLL];
  if (xchunks > 0) {
    Walk wx(xchunks);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u, wx.step())
      if (wx.r < nr)
        q[u] = __ldcs(reinterpret_cast<const uint4*>(
            x + ((size_t)(r0 + wx.r) * xchunks + wx.k) * 8));
  }
  __syncthreads();
  const int tchunks = chunks - xchunks;
  Walk wt(tchunks);
#pragma unroll
  for (int u = 0; u < UNROLL; ++u, wt.step())
    if (wt.r < nr)
      __stcs(reinterpret_cast<uint4*>(
                 o + ((size_t)wt.r * chunks + xchunks + wt.k) * 8),
             tail_chunk(z, sxyz + 3 * wt.r, sscene[wt.r], L, zvec, wt.k));
  if (xchunks > 0) {
    Walk wx(xchunks);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u, wx.step())
      if (wx.r < nr)
        __stcs(reinterpret_cast<uint4*>(
                   o + ((size_t)wx.r * chunks + wx.k) * 8), q[u]);
  }
}

// gx and the partial row [L] of column sums of work item blockIdx.x; thread
// (lane, chunk) = (tid / chunks, tid % chunks), lanes * chunks <= THREADS.
__global__ void __launch_bounds__(THREADS)
    scene_colsum_kernel(const bf16* __restrict__ d, bf16* __restrict__ gx,
                        float* __restrict__ partials, unsigned points,
                        int dcols, int L, int xchunks, int chunks, int lanes,
                        unsigned items_per_scene) {
  __shared__ float sums[THREADS * 8];
  const int lane = threadIdx.x / chunks, k = threadIdx.x % chunks;
  const int zw = 8 * (chunks - xchunks);     // a lane's row in `sums`
  const unsigned it = blockIdx.x, s = it / items_per_scene;
  const unsigned p0 = (it - s * items_per_scene) * ITEM_ROWS;
  const unsigned p1 = min(points, p0 + ITEM_ROWS);
  const size_t row0 = (size_t)s * points;
  if (lane < lanes) {
    float acc[8] = {};
    for (unsigned p = p0 + lane; p < p1; p += lanes * BWD_UNROLL) {
      uint4 q[BWD_UNROLL];
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const unsigned pp = p + u * lanes;
        if (pp < p1)
          q[u] = __ldcs(reinterpret_cast<const uint4*>(
              d + (row0 + pp) * dcols + 8 * k));
      }
#pragma unroll
      for (int u = 0; u < BWD_UNROLL; ++u) {
        const unsigned pp = p + u * lanes;
        if (pp >= p1) continue;
        if (k < xchunks) {
          __stcs(reinterpret_cast<uint4*>(
                     gx + ((row0 + pp) * xchunks + k) * 8), q[u]);
        } else {
          const __nv_bfloat162* h =
              reinterpret_cast<const __nv_bfloat162*>(&q[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h[e]);
            acc[2 * e] += f.x;
            acc[2 * e + 1] += f.y;
          }
        }
      }
    }
    if (k >= xchunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        sums[lane * zw + 8 * (k - xchunks) + e] = acc[e];
    }
  }
  __syncthreads();
  float* part = partials + (size_t)it * L;
  for (int c = threadIdx.x; c < L; c += THREADS) {
    float v = sums[c];
    for (int l = 1; l < lanes; ++l) v += sums[l * zw + c];
    part[c] = v;
  }
}

// dz[s, c] = the scene's partial rows summed in order.
__global__ void __launch_bounds__(THREADS)
    scene_finish_kernel(const float* __restrict__ partials,
                        float* __restrict__ dz, unsigned scenes, int L,
                        unsigned items_per_scene) {
  const unsigned idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= scenes * (unsigned)L) return;
  const unsigned s = idx / L, c = idx - s * L;
  const float* p = partials + (size_t)s * items_per_scene * L + c;
  float v = 0.f;
  unsigned i = 0;
  for (; i + 8 <= items_per_scene; i += 8) {
    float t[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) t[u] = p[(size_t)(i + u) * L];
#pragma unroll
    for (int u = 0; u < 8; ++u) v += t[u];
  }
  for (; i < items_per_scene; ++i) v += p[(size_t)i * L];
  dz[idx] = v;
}

}  // namespace

extern "C" {

// x [rows, xw] bf16 (null where xw == 0), z [scenes, L] fp32, xyz [rows, 3]
// fp32 -> out [rows, xw + tail] bf16, rows = scenes * points, tail = L + 3
// rounded up to 8. Returns the cudaError_t of the launch (0 = success).
int input_rows_launch(const void* x, int xw, const void* z, const void* xyz,
                      void* out, long long scenes, long long points, int L,
                      void* stream) {
  const long long rows = scenes * points;
  const long long chunks = (xw + (L + 3 + 7) / 8 * 8) / 8;
  if (scenes <= 0 || points <= 0 || L <= 0 || xw < 0 || xw % 8 ||
      (xw > 0 && (x == nullptr || !aligned16(x))) || !aligned16(out) ||
      rows > 0x7fffffffLL || chunks > TILE_CHUNKS)
    return static_cast<int>(cudaErrorInvalidValue);
  // the skip operand (x's copy) ran fastest on tiles of half the chunks
  // (82.6% of its bound against 77.9%), lin0's input on whole ones (84.0%
  // against 75.7%: H100, config 3's shapes)
  const int unroll = xw > 0 ? MAX_UNROLL / 2 : MAX_UNROLL;
  const int wider = xw / 8 > chunks - xw / 8 ? xw / 8 : (int)chunks - xw / 8;
  const int tile_rows = THREADS * unroll / wider;
  if (tile_rows == 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned tiles = (unsigned)((rows + tile_rows - 1) / tile_rows);
  auto kernel = unroll == MAX_UNROLL ? input_rows_kernel<MAX_UNROLL>
                                     : input_rows_kernel<MAX_UNROLL / 2>;
  kernel<<<tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(z),
      static_cast<const float*>(xyz), static_cast<bf16*>(out), (unsigned)rows,
      (unsigned)points, L, L % 4 == 0 && aligned16(z), xw / 8, (int)chunks,
      tile_rows);
  return static_cast<int>(cudaGetLastError());
}

// d [rows, dcols] bf16 -> gx [rows, xw] bf16 (skipped where xw == 0) and
// dz [scenes, L] fp32 through `partials` [scenes * items_per_scene(points),
// L] fp32; xw + L rounded up to 8 <= dcols.
int scene_colsum_launch(const void* d, int dcols, int xw, void* gx,
                        void* partials, void* dz, long long scenes,
                        long long points, int L, void* stream) {
  const int xchunks = xw / 8, chunks = xchunks + (L + 7) / 8;
  const long long items_per_scene = (points + ITEM_ROWS - 1) / ITEM_ROWS;
  if (scenes <= 0 || points <= 0 || L <= 0 || xw < 0 || xw % 8 ||
      dcols % 8 || 8 * chunks > dcols || chunks > MAX_CHUNKS ||
      !aligned16(d) || (xw > 0 && (gx == nullptr || !aligned16(gx))) ||
      scenes * points > 0x7fffffffLL ||
      scenes * items_per_scene > 0x7fffffffLL ||
      scenes * (long long)L > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scene_colsum_kernel<<<(unsigned)(scenes * items_per_scene), THREADS, 0, s>>>(
      static_cast<const bf16*>(d), static_cast<bf16*>(gx),
      static_cast<float*>(partials), (unsigned)points, dcols, L, xchunks,
      chunks, THREADS / chunks, (unsigned)items_per_scene);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long outs = scenes * L;
  scene_finish_kernel<<<(unsigned)((outs + THREADS - 1) / THREADS), THREADS,
                        0, s>>>(static_cast<const float*>(partials),
                                static_cast<float*>(dz), (unsigned)scenes, L,
                                (unsigned)items_per_scene);
  return static_cast<int>(cudaGetLastError());
}

// The constant the wrapper's plan rests on: a work item's rows, which size
// the partial rows it allocates.
void decoder_input_constants(int* out) { out[0] = ITEM_ROWS; }

}  // extern "C"
