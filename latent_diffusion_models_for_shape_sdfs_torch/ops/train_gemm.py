"""Layout of kernel #4's GEMM engine, in plain Python.

`csrc/fused_train.cu` (`tn_gemm_kernel`) computes the forward and dgrad
roles, C[M, N] = A[M, K] B[N, K]^T, with TMA copies into a ring of
128-byte-swizzled shared-memory stages, wgmma products and persistent
CTAs; `mn_wgrad_kernel` computes the wgrad role, per-chunk partials of
g^T h over the points, on the same ring, warps and wgmma with both
operands read MN-major (transposed) from their stored [points][cols]
layout. What the card cannot debug is modelled here: the constants
(`TN_LAYOUT`, `WGRAD_LAYOUT`, which the wrapper checks against the kernel
at load), the tensor maps' boxes, the persistent tile and split-K unit
schedules, the swizzle the TMA copies write and the K-major and MN-major
wgmma descriptors read, the accumulator's (row, col) map with the Philox
block exchange of the forward epilogue, the output tile the epilogue
stores into and the TMA store reads, and the keep bits the forward
writes and the dgrad reads (`keep_bit`, with the tensor pair
`pack_keep_bits` / `unpack_keep_bits` that the plain versions use).
tests/test_torch_train_gemm.py and tests/test_torch_train_mask.py check
the models on the CPU; nothing here runs on the card.
"""

from __future__ import annotations

import math

import torch

# csrc/fused_train.cu ft_gemm_layout(), in this order
TN_LAYOUT = dict(bm=128,            # tile rows: 64 per consumer warpgroup
                 bk=64,             # K per ring stage (one 128-byte row)
                 max_bn=256,        # widest tile
                 stages=3,          # ring stages
                 swizzle_bytes=128,
                 sbo=1024,          # descriptor: bytes between 8-row groups
                 stage_bytes=49152,  # A 128 x 64 + B 256 x 64, bf16
                 box=64,            # output tile: boxes of 64 x 64
                 threads=384,       # two consumer warpgroups + a producer's
                 # the ring, the 128 x 256 output tile, two column-partial
                 # buffers, 6 barriers, slack
                 smem=3 * 49152 + 65536 + 2 * 8192 + 6 * 8 + 1024,
                 # a column-partial buffer: a float2 per column-pair thread
                 # of each warpgroup and each of 4 sums
                 cbuf=2 * 128 * 4 * 8)
WG_ROWS = 64                        # rows of a tile per consumer warpgroup
WARP_ROWS = 16                      # rows of a tile per consumer warp
# csrc/fused_train.cu ft_wgrad_layout(), in this order
WGRAD_LAYOUT = dict(bm=128,         # tile rows (out): 64 per consumer warpgroup
                    bk=64,          # points per ring stage
                    max_bn=256,     # widest tile (in)
                    stages=4,       # ring stages
                    swizzle_bytes=128,
                    lbo=8192,       # descriptor: bytes between 64-column atoms
                    sbo=1024,       # descriptor: bytes between 8-point groups
                    stage_bytes=49152,  # g 2 boxes + h 4 boxes of 8 KB
                    threads=384,    # two consumer warpgroups + a producer's
                    # the ring, 8 barriers, slack
                    smem=4 * 49152 + 8 * 8 + 1024)
BOX = 64                            # a wgrad TMA box: 64 columns x 64 points
BOX_BYTES = BOX * WGRAD_LAYOUT["bk"] * 2
WGRAD_CHUNK = 16384                 # the most points a split-K chunk takes


def tile_width(n: int) -> int:
    """The engine's tile width for an output width n: 256 where it
    divides n, else 128."""
    if n <= 0 or n % 128:
        raise ValueError(f"train GEMM: width {n} is not a multiple of 128")
    return TN_LAYOUT["max_bn"] if n % TN_LAYOUT["max_bn"] == 0 else 128


def check_shape(m: int, n: int, k: int) -> int:
    """Raises ValueError unless the engine takes C[m, n] from K = k;
    returns the tile width."""
    if m <= 0 or m % TN_LAYOUT["bm"]:
        raise ValueError(f"train GEMM: {m} rows is not a positive multiple "
                         f"of {TN_LAYOUT['bm']}")
    if k <= 0 or k % TN_LAYOUT["bk"]:
        raise ValueError(f"train GEMM: K = {k} is not a positive multiple "
                         f"of {TN_LAYOUT['bk']}")
    return tile_width(n)


def tensor_map(rows: int, k: int, box_rows: int) -> dict:
    """The 2-D tensor map the kernel encodes for a row-major [rows][k] bf16
    operand: dims and box innermost first, the row stride in bytes."""
    return dict(dims=(k, rows), strides=(2 * k,),
                box=(TN_LAYOUT["bk"], box_rows),
                swizzle=TN_LAYOUT["swizzle_bytes"])


def gemm_maps(m: int, n: int, k: int) -> tuple:
    """(map of A [m][k], map of B [n][k], tile width)."""
    bn = check_shape(m, n, k)
    return tensor_map(m, k, TN_LAYOUT["bm"]), tensor_map(n, k, bn), bn


def tile_schedule(m: int, n: int, bn: int, grid: int) -> list:
    """Per CTA, the (m0, n0) of the tiles it walks: tile t = (m block,
    n block) with n fastest; CTA b takes t = b, b + grid, ..."""
    n_tiles = n // bn
    tiles = (m // TN_LAYOUT["bm"]) * n_tiles
    return [[((t // n_tiles) * TN_LAYOUT["bm"], (t % n_tiles) * bn)
             for t in range(b, tiles, grid)] for b in range(min(grid, tiles))]


def swizzle128(addr: int) -> int:
    """The 128-byte swizzle on a shared-memory byte address: bits 4-6 (the
    16-byte chunk within a 128-byte row) XOR bits 7-9 (the row mod 8)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_offset(row: int, kcol: int) -> int:
    """Byte offset from a 1024-aligned stage operand at which the TMA copy
    (box 64 of K x rows, 128-byte swizzle) puts element (row, kcol)."""
    return swizzle128(row * TN_LAYOUT["swizzle_bytes"] + 2 * kcol)


def sw128_desc(addr: int) -> int:
    """The wgmma descriptor csrc/sm90.cuh desc_sw128 builds for a K-major
    operand at shared address addr in the 128-byte swizzle mode."""
    return (((addr & 0x3FFFF) >> 4) | (1 << 16)
            | ((TN_LAYOUT["sbo"] >> 4) << 32) | (1 << 62))


def desc_fields(desc: int) -> dict:
    """A wgmma descriptor's fields, in bytes where they are addresses."""
    return dict(start=(desc & 0x3FFF) << 4, lbo=((desc >> 16) & 0x3FFF) << 4,
                sbo=((desc >> 32) & 0x3FFF) << 4, base=(desc >> 49) & 7,
                mode=(desc >> 62) & 3)


def wgmma_address(desc: int, row: int, k: int) -> int:
    """Shared address wgmma reads for element (row, k), k < 16, of a
    K-major operand in the 128-byte swizzle mode (mode 1): rows of 128
    bytes, 8-row groups SBO apart, the swizzle applied to the address."""
    f = desc_fields(desc)
    if f["mode"] != 1 or f["base"] != 0:
        raise ValueError(f"not a 128-byte swizzle descriptor: {f}")
    return swizzle128(f["start"] + (row // 8) * f["sbo"] + (row % 8) * 128
                      + 2 * k)


def out_offset(warp: int, lane: int, j: int, e: int) -> int:
    """Byte offset in a warpgroup's output tile (BN/64 boxes of 64 x 64,
    8 KB each) at which the epilogue stores accumulator 4j + e of lane
    `lane` of warp `warp`, as the kernel computes it: row 16 warp + lane/4
    (+8 for e >= 2), 4-byte word (lane % 4) of 16-byte chunk (j % 8) ^
    (lane/4) of box j // 8, half e % 2."""
    g, q = lane // 4, lane % 4
    return ((j // 8) * 64 * 64 * 2 + (16 * warp + g + 8 * (e // 2)) * 128
            + (((j % 8) ^ g) << 4) + 4 * q + 2 * (e % 2))


def box_offset(row: int, col: int) -> int:
    """Byte offset of element (row, col) of a warpgroup's 64 x BN output
    tile in the boxes the TMA store (and the dgrad's h_prev load) reads
    (writes): box col // 64 in the 128-byte swizzle layout."""
    return (col // 64) * 64 * 64 * 2 + tma_offset(row, col % 64)


def acc_coords(warp: int, lane: int, i: int) -> tuple:
    """(row, col) within a warpgroup's 64 x BN tile of accumulator register
    i of lane `lane` of warp `warp` (0-3 in the warpgroup): the m16n8 C
    fragment of mma.sync repeated over column blocks j = i // 4."""
    j, e = divmod(i, 4)
    return (16 * warp + lane // 4 + 8 * (e // 2),
            8 * j + 2 * (lane % 4) + e % 2)


def dropout_words(warp: int, lane: int, j: int, row0: int = 0,
                  n0: int = 0) -> list:
    """The forward epilogue's dropout exchange for column block j: for the
    lane's four values (acc 4j .. 4j+3), the (row, group, word) of the
    Philox block word each is masked with. Lane q of a quad draws the
    block (row r0 if q is even, r0 + 8 if odd; group col >> 2); the pair
    q, q^1 swaps the two words the other needs (words 0-1 belong to the
    even lane's columns, 2-3 to the odd one's)."""
    def drawn(ln):
        r = row0 + 16 * warp + ln // 4 + (8 if ln % 2 else 0)
        g = (n0 + 8 * j + 2 * (ln % 4)) >> 2
        return r, g

    odd = lane % 2 == 1
    own, other = drawn(lane), drawn(lane ^ 1)
    # what the partner sends: words (0, 1) if it is odd, else (2, 3)
    sent = (0, 1) if not odd else (2, 3)
    words = [(other, sent[0]) if odd else (own, 0),
             (other, sent[1]) if odd else (own, 1),
             (own, 2) if odd else (other, sent[0]),
             (own, 3) if odd else (other, sent[1])]
    return [(r, g, w) for (r, g), w in words]


# ------------------------------------------------------------- keep bits


def keep_word(tile: int, wg: int, warp: int, lane: int, bn: int) -> int:
    """Index of the first of the BN/64 keep words of an engine thread:
    lane `lane` of warp `warp` (0-3) of warpgroup `wg` of tile `tile` (m
    block, n block, n fastest), threads in (tile, warpgroup, warp, lane)
    order; a thread writes (forward) or reads (dgrad) its own BN/64
    consecutive words (keep_acc_bit)."""
    wgs = TN_LAYOUT["bm"] // WG_ROWS
    return (((tile * wgs + wg) * 4 + warp) * 32 + lane) * (bn // 64)


def keep_acc_bit(i: int) -> tuple:
    """(word after the thread's first, bit) of the thread's accumulator i
    = 4 j + e (acc_coords): word j // 8; bit j % 8, + 8 for row r0 + 8 (e
    >= 2), + 16 for column c + 1 (e odd). The kernel builds each column
    block's four bits from the flags of its two packed bf16 pairs (bits
    15 and 31), shifted into place (csrc/fused_train.cu keep_flags)."""
    j, e = divmod(i, 4)
    return j // 8, j % 8 + 8 * (e // 2) + 16 * (e % 2)


def keep_bit(row: int, col: int, n: int) -> tuple:
    """(word, bit) of element (row, col) of an [M, n] activation in the
    keep-bit layout: the engine thread whose accumulator holds (row, col)
    when it tiles an [M, n] output (tile width tile_width(n)), and the
    accumulator's index (acc_coords inverted)."""
    bn, bm = tile_width(n), TN_LAYOUT["bm"]
    tile = (row // bm) * (n // bn) + col // bn
    rr, cc = row % bm, col % bn
    lane = 4 * (rr % 8) + (cc % 8) // 2
    i = 4 * (cc // 8) + 2 * ((rr % WARP_ROWS) // 8) + cc % 2
    word = keep_word(tile, rr // WG_ROWS, (rr % WG_ROWS) // WARP_ROWS, lane,
                     bn)
    w, bit = keep_acc_bit(i)
    return word + w, bit


def _keep_dims(m: int, n: int) -> tuple:
    """[M, n] as (m block, warpgroup, warp, row half, row % 8, n block,
    word, column block in the word, column pair, column in the pair), and
    the permutation to the layout's order (m block, n block, warpgroup,
    warp, row % 8, column pair | word, column in the pair, row half,
    column block): lane = 4 (row % 8) + pair; bit = 16 col + 8 half +
    block."""
    bn, bm = tile_width(n), TN_LAYOUT["bm"]
    if m % bm:
        raise ValueError(f"keep bits: {m} rows is not a multiple of {bm}")
    dims = (m // bm, bm // WG_ROWS, WG_ROWS // WARP_ROWS, 2, 8, n // bn,
            bn // 64, 8, 4, 2)
    return dims, (0, 5, 1, 2, 4, 8, 6, 9, 3, 7)


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """The keep bits of a bool [M, n] mask (`h > 0`) in the layout of
    keep_bit: int32 [M n / 32], bit b of word w = keep_bit's (w, b)."""
    dims, perm = _keep_dims(*keep.shape)
    b = keep.reshape(dims).permute(perm).reshape(-1, 32)
    words = torch.zeros(b.shape[0], dtype=torch.int32, device=keep.device)
    for i in range(32):
        words |= b[:, i].to(torch.int32) << i
    return words


def unpack_keep_bits(words: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """The bool [m, n] mask of pack_keep_bits' words."""
    dims, perm = _keep_dims(m, n)
    if words.dtype != torch.int32 or words.numel() * 32 != m * n:
        raise ValueError(f"keep bits: {words.dtype} x {words.numel()} "
                         f"words for [{m}, {n}]")
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    b = ((words.reshape(-1, 1) >> shifts) & 1).bool()
    inv = [perm.index(d) for d in range(len(perm))]
    return b.reshape([dims[d] for d in perm]).permute(inv).reshape(m, n)


# ------------------------------------------------------------ wgrad role


def wgrad_chunk(n_points: int) -> int:
    """The split-K chunk the pass gives the wgrad role for n_points: the
    largest power of two dividing n_points, at most WGRAD_CHUNK. It
    depends on the shape alone (never on the card's SM count), so the
    partials, and their fixed-order sum, are the same on any grid."""
    return math.gcd(n_points, WGRAD_CHUNK)


def check_wgrad_shape(m: int, n: int, k: int, k_split: int) -> int:
    """Raises ValueError unless the wgrad kernel takes partials [k //
    k_split, m, n] from K = k points; returns the tile width."""
    if m <= 0 or m % WGRAD_LAYOUT["bm"]:
        raise ValueError(f"wgrad GEMM: out width {m} is not a positive "
                         f"multiple of {WGRAD_LAYOUT['bm']}")
    bn = tile_width(n)
    if (k_split <= 0 or k_split % WGRAD_LAYOUT["bk"] or k <= 0
            or k % k_split or k >= 2 ** 31):
        raise ValueError(f"wgrad GEMM: chunk {k_split} must be a positive "
                         f"multiple of {WGRAD_LAYOUT['bk']} points dividing "
                         f"K = {k}")
    return bn


def mn_tensor_map(points: int, cols: int) -> dict:
    """The 2-D tensor map the wgrad kernel encodes for a row-major
    [points][cols] bf16 operand (g or h): dims and box innermost first,
    the row stride in bytes; a box is 64 columns (one 128-byte row) x 64
    points."""
    return dict(dims=(cols, points), strides=(2 * cols,),
                box=(BOX, WGRAD_LAYOUT["bk"]),
                swizzle=WGRAD_LAYOUT["swizzle_bytes"])


def wgrad_maps(m: int, n: int, k: int, k_split: int) -> tuple:
    """(map of g [k][m], map of h [k][n], tile width)."""
    bn = check_wgrad_shape(m, n, k, k_split)
    return mn_tensor_map(k, m), mn_tensor_map(k, n), bn


def wgrad_schedule(m: int, n: int, bn: int, k: int, k_split: int,
                   grid: int) -> list:
    """Per CTA, the (m0, n0, k0) of the units it walks: unit u = (tile u %
    tiles, chunk u // tiles), tile = (m block, n block) with n fastest;
    CTA b takes u = b, b + grid, ...; the chunk of unit u covers points
    k0 .. k0 + k_split - 1."""
    n_tiles = n // bn
    tiles = (m // WGRAD_LAYOUT["bm"]) * n_tiles
    units = tiles * (k // k_split)
    return [[(((u % tiles) // n_tiles) * WGRAD_LAYOUT["bm"],
              (u % tiles) % n_tiles * bn, (u // tiles) * k_split)
             for u in range(b, units, grid)] for b in range(min(grid, units))]


def mn_tma_offset(point: int, col: int) -> int:
    """Byte offset from a 1024-aligned stage operand at which the wgrad
    kernel's TMA copies put element (point, col), point < 64: box col //
    64 (8 KB each, side by side), in it row = point (128 bytes), the
    128-byte swizzle."""
    return (col // BOX) * BOX_BYTES + swizzle128(
        point * WGRAD_LAYOUT["swizzle_bytes"] + 2 * (col % BOX))


def mn_sw128_desc(addr: int, lbo: int) -> int:
    """The wgmma descriptor csrc/sm90.cuh desc_sw128_mn builds for an
    MN-major operand at shared address addr in the 128-byte swizzle mode:
    LBO between 64-element MN atoms, SBO between 8-row groups of K."""
    return (((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | ((WGRAD_LAYOUT["sbo"] >> 4) << 32) | (1 << 62))


def mn_wgmma_address(desc: int, mn: int, k: int) -> int:
    """Shared address wgmma reads (transpose bit set) for element (mn, k),
    k < 16, of an MN-major operand in the 128-byte swizzle mode: 64-element
    MN atoms LBO apart, each K row of an atom 128 bytes, 8-row groups of K
    SBO apart, the swizzle applied to the address."""
    f = desc_fields(desc)
    if f["mode"] != 1 or f["base"] != 0:
        raise ValueError(f"not a 128-byte swizzle descriptor: {f}")
    return swizzle128(f["start"] + (mn // BOX) * f["lbo"] + (k // 8) * f["sbo"]
                      + (k % 8) * 128 + 2 * (mn % BOX))
