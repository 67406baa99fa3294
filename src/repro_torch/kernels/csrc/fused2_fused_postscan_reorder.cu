// K2f: the fused two-digit WMS/BMS postscan: two radix digits a tile
// residency. The tile is sorted stably by its pair digit in shared memory
// (an LSD sweep of sub-digit stages), each key's stable rank in its cell
// (seg, pair) is its position minus the head of the cell's run, its global
// destination is G[tile, seg·m² + pair] + rank, and keys, values and
// destinations go out (seg, pair)-major within the tile in coalesced
// writes; the caller's one scatter a pair replaces the two scatters of two
// chained single-digit passes, bit for bit.
//
// Replaces fused2_fused_postscan_reorder_pallas
// (src/repro/kernels/multisplit_tile.py:973), whose body is
// fused2_postscan_body (src/repro/kernels/common.py:521). One kernel body,
// four forms (template flags): flat or segmented (a segment strip that
// never decreases along a tile), and the onehot (warp-ballot) or packed
// (8-bit subword counters) rank in the sweep's stages. The result depends
// on neither the family nor the stage width `sub` (1 to 8 bits).
//
// keys (L, T) 32-bit integer words [, seg (L, T) int32], G (L, s·m²) int32,
// optional values (L, T) 32-bit words -> keys_r, vals_r, pos_r (L, T),
// (seg, pair)-major within each tile, pos_r the global destination of each
// reordered slot, and perm (L, T) int32, the element-order destination.
//
// Bound: memory. It reads 4 bytes a key (and a value) [, 4 of segment id]
// and the G bases of the cells its keys hit, and writes keys_r, pos_r, perm
// (and vals_r): (16·L·T) bytes key-only and (24·L·T) key-value [+ 4·L·T
// segmented] and 4 bytes a distinct (tile, cell), over 3.35 TB/s on an H100
// SXM. At sector grain the G reads are the 32-byte sectors of each tile's
// row that its keys hit: at F1 (tiles of 8192 keys over 65536 pairs) most
// of the distinct cells sit in sectors of their own, so the G row costs
// nearly as much as the keys and values together (chip_smoke.py prints
// both bounds).
//
// Design for Hopper: the body it shares with K3f, fused2::postscan_kernel
// (multisplit_fused2.cuh), whose notes give the design: persistent blocks
// of 8 warps, two an SM at T = 8192; the sort by (segment run, pair) in an
// LSD sweep of `sub`-bit stages on the shared warp ranks, 16-bit ranks two
// to a register; the head words and G read once a key in sorted order; the
// values through the free key buffer. This file is its entry point.
#include "multisplit_fused2.cuh"

// segs: the segment strip, or null for the flat layout (s = 1). vals and
// vals_r are null for a key-only reorder. The pair is `bits` wide at
// `shift` (1 <= bits <= 16, shift + bits <= 32), swept `sub` bits a stage
// (1 <= sub <= 8); packed selects the packed rank for the stages. Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a tile the kernel does not take (T above 8192), a pair or stage width
// outside those ranges or no segment.
extern "C" int ms_fused2_fused_postscan_reorder(const void* keys, const void* segs, const void* g,
                                                const void* vals, void* keys_r, void* vals_r,
                                                void* pos_r, void* perm, int n_tiles, int T, int s,
                                                int shift, int bits, int sub, int packed,
                                                void* stream) {
  return fused2::launch<false>(keys, segs, g, vals, keys_r, vals_r, pos_r, perm, n_tiles, T, s,
                               shift, bits, sub, packed, stream);
}
