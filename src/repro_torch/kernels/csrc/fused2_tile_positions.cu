// K3f: the fused two-digit DMS postscan: each key's global destination
// G[tile, seg·m² + pair] + its stable rank in its cell, in element order.
// No key moves in device memory.
//
// Replaces fused2_tile_positions_pallas
// (src/repro/kernels/multisplit_tile.py:909), whose body is
// fused2_positions_body (src/repro/kernels/common.py:652). One kernel body,
// four forms (template flags): flat or segmented, onehot or packed stage
// rank; the result depends on neither the family nor the stage width.
//
// keys (L, T) 32-bit integer words [, seg (L, T) int32], G (L, s·m²) int32
// -> (L, T) int32 destinations: exactly K2f's perm.
//
// Bound: memory. It reads 4 bytes a key [, 4 of segment id] and the G bases
// of the cells its keys hit, and writes 4 bytes a key: (8·L·T) bytes [+
// 4·L·T segmented] and 4 bytes a distinct (tile, cell), over 3.35 TB/s on an
// H100 SXM. At sector grain the G reads are the 32-byte sectors of each
// tile's row that its keys hit, as for K2f: at F1 most of the distinct
// cells sit in sectors of their own (chip_smoke.py prints both bounds).
//
// Design for Hopper: K2f's sort and walk, the one body both kernels
// instantiate (fused2::postscan_kernel, multisplit_fused2.cuh), in its
// positions-only form: persistent blocks of 8 warps, two an SM at T = 8192;
// the tile sorted by (segment run, pair) in an LSD sweep of `sub`-bit
// stages; the cell heads and G read once a key in sorted order; each
// destination scattered by source index into the sorted key buffer once
// the walk has read it, then stored in element order, 16 bytes a store
// where aligned. It writes no keys_r, vals_r or pos_r and reads no values,
// so the barriers that guard them go.
#include "multisplit_fused2.cuh"

// segs: the segment strip, or null for the flat layout (s = 1). The pair is
// `bits` wide at `shift` (1 <= bits <= 16, shift + bits <= 32), swept `sub`
// bits a stage (1 <= sub <= 8); packed selects the packed rank for the
// stages. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a tile the kernel does not take (T above 8192),
// a pair or stage width outside those ranges or no segment.
extern "C" int ms_fused2_tile_positions(const void* keys, const void* segs, const void* g,
                                        void* pos, int n_tiles, int T, int s, int shift, int bits,
                                        int sub, int packed, void* stream) {
  return fused2::launch<true>(keys, segs, g, nullptr, nullptr, nullptr, nullptr, pos, n_tiles, T,
                              s, shift, bits, sub, packed, stream);
}
