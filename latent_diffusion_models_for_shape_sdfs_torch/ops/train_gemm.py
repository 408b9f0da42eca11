"""Layout of kernel #4's forward/dgrad GEMM engine, in plain Python.

`csrc/fused_train.cu` (`tn_gemm_kernel`) computes C[M, N] = A[M, K]
B[N, K]^T with TMA copies into a ring of 128-byte-swizzled shared-memory
stages, wgmma products and persistent CTAs. What the card cannot debug is
modelled here: the constants (`TN_LAYOUT`, which the wrapper checks
against the kernel at load), the tensor maps' boxes, the persistent tile
schedule, the swizzle the TMA copies write and the wgmma descriptors read,
the accumulator's (row, col) map with the Philox block exchange of the
forward epilogue, and the output tile the epilogue stores into and the
TMA store reads. tests/test_torch_train_gemm.py checks the models on the
CPU; nothing here runs on the card.
"""

from __future__ import annotations

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
                 # the ring, the 128 x 256 output tile, 8 barriers, slack
                 smem=3 * 49152 + 65536 + 8 * 8 + 1024)
WG_ROWS = 64                        # rows of a tile per consumer warpgroup


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
