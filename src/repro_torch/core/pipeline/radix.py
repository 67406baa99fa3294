"""RadixPipeline: chained LSD digit passes on resident buffers (paper §7.1),
flat and segmented layouts. Counterpart of
``repro/core/pipeline/radix.py:99-266``.

* the tile is resolved ONCE (by the widest digit) and every pass shares it;
* the keys/values buffers are padded ONCE with the all-ones key, whose
  digit is m−1 in EVERY pass, so after each stable pass the pads are back at
  the tail and the next pass takes the padded buffer as it is (ping-pong:
  each pass scatters into a new buffer that the next pass reads);
* each pass is one :meth:`MultisplitPlan.run_tiled` sweep;
* the pad tail is cut off once, after the last pass;
* segmented (``segments=s``): the segment strip is built once and kept for
  every pass (elements never cross a segment boundary), with its pads in
  segment s−1, so the pads stay at the tail there too.

The untiled reference backend iterates the direct solve per pass. Fused
two-digit passes are ROADMAP queue A item 7; the batched layout item 5.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.core.identifiers import is_integer
from repro_torch.core.pipeline import stages as _st
from repro_torch.core.pipeline.registry import get_backend
from repro_torch.core.pipeline.spec import make_radix_plan
from repro_torch.core.pipeline.tiles import resolve_tile

Tensor = torch.Tensor


def radix_passes(radix_bits: int, key_bits: int) -> List[Tuple[int, int]]:
    """The (shift, bits) schedule of an LSD radix sort; the final pass may
    cover fewer bits (r=7 over 32-bit keys: 4 passes of 7 and one of 4)."""
    n_pass = math.ceil(key_bits / radix_bits)
    return [
        (k * radix_bits, min(radix_bits, key_bits - k * radix_bits))
        for k in range(n_pass)
    ]


class RadixPipeline:
    """A resolved ⌈key_bits/r⌉-pass radix sort over one shape: flat
    ``(n,)`` keys, or ragged segments over them (``segments=s`` and a
    ``segment_starts`` call argument). Build once, call with tensors."""

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
        segments: Optional[int] = None,
        family: Optional[str] = None,
    ):
        self.n = n
        self.key_value = key_value
        self.backend = backend
        self.segments = segments
        self.passes = radix_passes(radix_bits, key_bits)
        # ONE tile for every pass, keyed by the widest digit (the first)
        m_eff = (1 << self.passes[0][1]) * (segments or 1)
        self.tile = resolve_tile(n, m_eff, method, key_value, backend, tile)
        self.plans = tuple(
            make_radix_plan(
                n, shift, bits, method=method, key_value=key_value, backend=backend,
                tile=self.tile, segments=segments, family=family,
            )
            for shift, bits in self.passes
        )

    @property
    def n_passes(self) -> int:
        return len(self.passes)

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
