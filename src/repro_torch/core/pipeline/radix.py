"""RadixPipeline: chained LSD digit passes on resident buffers (paper §7.1),
flat, batched and segmented layouts. Counterpart of
``repro/core/pipeline/radix.py:99-301``.

* the tile is resolved ONCE (by the widest digit) and every pass shares it;
* the keys/values buffers are padded ONCE with the all-ones key, whose
  digit is m−1 in EVERY pass, so after each stable pass the pads are back at
  the tail and the next pass takes the padded buffer as it is (ping-pong:
  each pass scatters into a new buffer that the next pass reads);
* each pass is one :meth:`MultisplitPlan.run_tiled` sweep;
* the pad tail is cut off once, after the last pass;
* segmented (``segments=s``): the segment strip is built once and kept for
  every pass (elements never cross a segment boundary), with its pads in
  segment s−1, so the pads stay at the tail there too;
* batched (``batch=b``, ``(b, n)`` keys): every row is padded once to whole
  tiles and each pass is one ``run_tiled(..., rows=b)`` sweep over all rows,
  whose pads stay at each row's tail.

The untiled reference backend iterates the direct solve per pass.

``fuse_digits=True`` runs adjacent digit passes as fused pairs
(``radix.py:50-185`` of the JAX package): :func:`radix_pass_pairs` merges
them into ``(shift, bits, split)`` entries, each pair one sweep over the
combined digit (K1f and K2f or K3f on the card), a trailing unpaired digit
one single-digit sweep. Backends without ``fuses_digits`` (the untiled
reference) keep the single-digit schedule: fusing changes the cost, never
the result. Every plan of the schedule, fused pairs included, takes the
pipeline's ``batch``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.identifiers import is_integer
from repro_torch.core.pipeline import stages as _st
from repro_torch.core.pipeline.registry import get_backend
from repro_torch.core.pipeline.spec import make_radix_plan
from repro_torch.core.pipeline.tiles import resolve_kernel_family, resolve_tile

Tensor = torch.Tensor


def radix_passes(radix_bits: int, key_bits: int) -> List[Tuple[int, int]]:
    """The (shift, bits) schedule of an LSD radix sort; the final pass may
    cover fewer bits (r=7 over 32-bit keys: 4 passes of 7 and one of 4)."""
    n_pass = math.ceil(key_bits / radix_bits)
    return [
        (k * radix_bits, min(radix_bits, key_bits - k * radix_bits))
        for k in range(n_pass)
    ]


# The widest pair of the fused schedule: a pair's combined digit is the scan
# axis (m² = 2^bits columns of H a tile and segment), and 16 bits is where
# the JAX package stops pairing.
MAX_PAIR_BITS = 16


def radix_pass_pairs(
    radix_bits: int, key_bits: int, max_pair_bits: int = MAX_PAIR_BITS
) -> List[Tuple[int, int, Optional[int]]]:
    """The fused-pair schedule: adjacent passes of :func:`radix_passes`
    merged greedily into ``(shift, bits, split)`` entries, ``split`` the
    low digit's width in the pair, ``None`` an unpaired single pass (the
    trailing odd digit, or a pair wider than ``max_pair_bits``). r = 8 over
    32-bit keys gives ``[(0, 16, 8), (16, 16, 8)]``; r = 7 two 14-bit pairs
    and a 4-bit single pass; r = 4 over 30-bit keys ends in ``(24, 6, 4)``."""
    passes = radix_passes(radix_bits, key_bits)
    out: List[Tuple[int, int, Optional[int]]] = []
    i = 0
    while i < len(passes):
        if i + 1 < len(passes):
            (s_a, b_a), (_, b_b) = passes[i], passes[i + 1]
            if b_a + b_b <= max_pair_bits:
                out.append((s_a, b_a + b_b, b_a))
                i += 2
                continue
        shift, bits = passes[i]
        out.append((shift, bits, None))
        i += 1
    return out


class RadixPipeline:
    """A resolved ⌈key_bits/r⌉-pass radix sort over one shape: flat
    ``(n,)`` keys, ``(b, n)`` rows sorted each on its own (``batch=b``), or
    ragged segments over flat keys (``segments=s`` and a
    ``segment_starts`` call argument). Build once, call with tensors. With
    ``fuse_digits`` on a backend that fuses digits the schedule is
    :func:`radix_pass_pairs`; ``sub_bits`` pins the pairs' in-tile stage
    width."""

    def __init__(
        self,
        n: int,
        *,
        radix_bits: int = 8,
        key_bits: int = 32,
        method: str = "bms",
        key_value: bool = False,
        backend: str = "vmap",
        tile: Optional[int] = None,
        batch: Optional[int] = None,
        segments: Optional[int] = None,
        family: Optional[str] = None,
        fuse_digits: bool = False,
        sub_bits: Optional[int] = None,
    ):
        self.n = n
        self.key_value = key_value
        self.backend = backend
        self.batch = batch
        self.segments = segments
        self.passes = radix_passes(radix_bits, key_bits)
        s = segments or 1
        be = get_backend(backend)
        if fuse_digits and be.tiled and be.fuses_digits:
            # one sweep a pair; ONE tile and family for every sweep, the
            # tile at the first pair's width, the family at its stage width,
            # both under the digits=2 slot, never a digits=1 plan's
            self.schedule = radix_pass_pairs(radix_bits, key_bits)
            _, bits0, split0 = self.schedule[0]
            stage_m = (1 << (split0 or bits0)) * s
            self.family = resolve_kernel_family(n, stage_m, method, backend, family, digits=2,
                                                key_value=key_value, pair_m=(1 << bits0) * s)
            self.tile = resolve_tile(n, (1 << bits0) * s, method, key_value, backend, tile,
                                     digits=2, stage_m=stage_m, family=family)
        else:
            self.schedule = [(shift, bits, None) for shift, bits in self.passes]
            # ONE tile for every pass, keyed by the widest digit (the first)
            m_eff = (1 << self.passes[0][1]) * s
            self.family = family
            self.tile = resolve_tile(n, m_eff, method, key_value, backend, tile)
        self.plans = tuple(
            make_radix_plan(
                n, shift, bits, method=method, key_value=key_value, backend=backend,
                tile=self.tile, batch=batch, segments=segments, family=self.family,
                digit_split=split,
                sub_bits=sub_bits if split is not None else None,
            )
            for shift, bits, split in self.schedule
        )

    @property
    def n_passes(self) -> int:
        """Logical single-digit passes, ⌈key_bits/r⌉, whatever the schedule."""
        return len(self.passes)

    @property
    def n_sweeps(self) -> int:
        """Sweeps run, one a schedule entry: a fused pair counts once."""
        return len(self.plans)

    def __call__(
        self, keys: Tensor, values: Optional[Tensor] = None, segment_starts=None,
    ) -> Tuple[Tensor, Optional[Tensor]]:
        if (values is not None) != self.key_value:
            raise ValueError(
                f"radix pipeline resolved for key_value={self.key_value} but "
                f"called with values={'present' if values is not None else 'absent'}"
            )
        if not is_integer(keys.dtype):
            raise TypeError(
                f"radix sort requires integer keys, got {keys.dtype}; reinterpret "
                f"the buffer (tensor.view(torch.uint32)) first"
            )
        if self.batch is not None:
            if segment_starts is not None:
                raise ValueError("pipeline is not segmented; segment_starts not accepted")
            return self._call_batched(keys, values)
        if keys.dim() != 1 or keys.shape[0] != self.n:
            raise ValueError(f"radix pipeline resolved for keys of shape ({self.n},), got {tuple(keys.shape)}")
        starts, seg_ids = self.plans[0]._segment_ids(keys, segment_starts)
        if self.n == 0:
            return keys, values

        be = get_backend(self.backend)
        if not be.tiled:
            for plan in self.plans:
                res = plan(keys, values, segment_starts=starts)
                keys, values = res.keys, res.values
            return keys, values

        be.check_keys(keys)
        tile = self.tile
        # ---- pad ONCE: the all-ones key sorts to the tail in every pass
        keys_pad, _ = _st.pad_to_tiles(keys.contiguous(), tile, self.plans[0].pad_key(keys.dtype))
        vals_pad = None
        if values is not None:
            vals_pad, _ = _st.pad_to_tiles(values.contiguous(), tile, 0)
        seg_tiled = None
        if seg_ids is not None:
            # position-keyed and the same for every pass
            seg_tiled = _st.pad_to_tiles(seg_ids, tile, self.segments - 1)[0].view(-1, tile)

        # ---- chained passes on resident buffers (views are free)
        for plan in self.plans:
            vals_tiled = vals_pad.view(-1, tile) if vals_pad is not None else None
            keys_pad, vals_pad, _, _ = plan.run_tiled(
                keys_pad.view(-1, tile), None, vals_tiled, seg_tiled)

        # ---- cut the pad tail off ONCE
        return keys_pad[:self.n], (vals_pad[:self.n] if values is not None else None)

    def _call_batched(
        self, keys: Tensor, values: Optional[Tensor]
    ) -> Tuple[Tensor, Optional[Tensor]]:
        """Every row of ``(b, n)`` keys sorted on its own: pad every row
        once, chain the sweeps over all rows, cut the pads off once."""
        b, n = self.batch, self.n
        if tuple(keys.shape) != (b, n):
            raise ValueError(
                f"batched radix pipeline resolved for shape {(b, n)}, got {tuple(keys.shape)}"
            )
        if values is not None and values.shape != keys.shape:
            raise ValueError(f"values must have shape {(b, n)}, got {tuple(values.shape)}")
        if n == 0:
            return keys, values

        be = get_backend(self.backend)
        if not be.tiled:
            for plan in self.plans:
                res = plan(keys, values)
                keys, values = res.keys, res.values
            return keys, values

        be.check_keys(keys)
        tile = self.tile
        n_row = -(-n // tile) * tile
        keys_pad = _st.pad_rows(keys, n_row, self.plans[0].pad_key(keys.dtype))
        vals_pad = _st.pad_rows(values, n_row, 0) if values is not None else None
        for plan in self.plans:
            vals_tiled = vals_pad.view(-1, tile) if vals_pad is not None else None
            keys_pad, vals_pad, _, _ = plan.run_tiled(
                keys_pad.view(-1, tile), None, vals_tiled, rows=b)
        return keys_pad[:, :n], (vals_pad[:, :n] if values is not None else None)
