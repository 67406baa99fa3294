"""PipelineSpec and the executable plan of the flat and segmented layouts:
the stage graph of the multisplit pipeline (paper §4.1), with
partial-pipeline modes. Counterpart of ``repro/core/pipeline/spec.py``
(``:131-165, 329-334, 435-452, 550-858``).

``mode`` selects how much of the pipeline runs:

* ``reorder`` (default): {prescan, scan, postscan(+reorder), scatter} —
  stable bucket-major output;
* ``counts_only``: {prescan, reduce} — the paper's §7.3 histogram;
* ``positions_only``: {prescan, scan, postscan-positions} — the eq. (2)
  destinations without moving any key.

Pads ride in (segment s−1,) bucket m−1 at the tail: fused-label plans pad
with the spec's pad key (for the radix digit, the all-ones key, digit m−1
in every pass), so pads land after every real element and
``finalize_counts`` takes them out of the last combined bucket.

``segments=s`` selects the segmented layout: flat ``(n,)`` keys plus an
``(s,)`` ``segment_starts`` call argument; every segment is multisplit on
its own, in one launch per stage, with the segment id riding as the high
part of the combined id ``seg·m + b`` (width ``m_eff = s·m``).

``batch=b`` selects the batched layout (``spec.py:463-548`` of the JAX
package): ``(b, n)`` keys, every row multisplit on its own. Each row is
padded to ``l_b`` whole tiles, so every tile belongs to one row and one grid
of ``b·l_b`` tiles runs the flat stages; the scan runs per row and the
scatter adds ``row·n_row`` to the row-local destinations. Each row's pads
ride in bucket m−1 at its tail and come out of that row's counts.

``digit_split`` marks a fused two-digit radix plan (``spec.py:114-139`` of
the JAX package): the bucket spec is the pair's ``BitfieldSpec`` and
``digit_split`` the low digit's width; its stages run the fused2 bodies on
the key strip, bitwise equal to the plain plan over the pair (the LSD
identity: two chained stable passes equal one stable pass over the pair).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.identifiers import BitfieldSpec, BucketSpec, as_spec
from repro_torch.core.pipeline import stages as _st
from repro_torch.core.pipeline.registry import get_backend
from repro_torch.core.pipeline.stages import MultisplitResult
from repro_torch.core.pipeline.tiles import (
    resolve_kernel_family,
    resolve_sub_bits,
    resolve_tile,
)

Tensor = torch.Tensor

MODES = ("reorder", "counts_only", "positions_only")

# (backend, spec kind, m_eff) -> (fused?, reason): every label-fusion choice
# of :meth:`PipelineSpec.label_fusion`, recorded with its reason as the JAX
# package records it (``spec.py:54-78``). The JAX package's vmap ceiling
# (``VMAP_FUSION_MAX_BUCKETS = 512``) was measured with jnp on a CPU host and
# is not the port's: the vmap stages fuse every fusable spec unless the
# autotuner (``set_autotune``) measured otherwise for the shape.
_FUSION_CACHE: dict = {}


def fusion_decision(backend: str, spec_kind: str, m_eff: int):
    """(fused?, reason) recorded for one (backend, spec kind, m_eff) shape,
    or None if no call of that shape decided yet."""
    return _FUSION_CACHE.get((backend, spec_kind, m_eff))


def fusion_decisions() -> dict:
    """A snapshot of every recorded label-fusion decision."""
    return dict(_FUSION_CACHE)


class Stage(NamedTuple):
    """One node of a plan's stage graph: ``name`` the pipeline role
    (layout, prescan, scan, postscan, reduce, scatter, direct-solve),
    ``impl`` its implementation tag."""

    name: str
    impl: str


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A declarative multisplit pipeline for one problem shape.

    Frozen and hashable by value (``bucket_fn`` is a value-hashable spec).
    Build it with :func:`make_plan`, :func:`make_radix_plan` or their
    segmented forms. ``digit_split`` is the low digit's width of a fused
    pair (None for a single-digit plan) and ``sub_bits`` the pair's in-tile
    stage width (None: the stage bodies' default)."""

    n: int
    num_buckets: int
    method: str                     # dms | wms | bms
    key_value: bool
    backend: str
    tile: int
    bucket_fn: Optional[BucketSpec] = None
    batch: Optional[int] = None     # a leading (b, n) axis
    segments: Optional[int] = None  # ragged segments over (n,)
    mode: str = "reorder"
    family: str = "onehot"
    digit_split: Optional[int] = None
    sub_bits: Optional[int] = None

    @property
    def m_eff(self) -> int:
        """Width of the histograms and the scan: ``s·m`` for segmented
        plans, else m."""
        return self.num_buckets * (self.segments or 1)

    @property
    def layout(self) -> str:
        """flat | batched | segmented."""
        if self.segments is not None:
            return "segmented"
        return "flat" if self.batch is None else "batched"

    def _with_layout(self, base: Tuple[str, ...]) -> Tuple[str, ...]:
        if self.batch is not None:
            return (f"layout:batched[{self.batch}]",) + base
        if self.segments is not None:
            return (f"layout:segmented[{self.segments}]",) + base
        return base

    def ids_fn(self) -> BucketSpec:
        if self.bucket_fn is None:
            raise ValueError("plan has no bucket spec")
        return self.bucket_fn

    def label_fusion(self, keys: Tensor) -> bool:
        """Whether this call computes bucket ids inside the tile stage: a
        fusable spec on a label-fusing tiled backend, with keys of the
        backend's width. Otherwise the labels are materialised
        (:meth:`_host_labels`) and the stages take the ids strip. Each
        eligible shape's choice is recorded with its reason
        (:func:`fusion_decision`): the kernels and the radix digit always
        fuse; on ``vmap`` an armed autotuner measures the choice
        (``autotune.maybe_tune_fusion``), else the stages fuse."""
        bf = self.bucket_fn
        be = get_backend(self.backend)
        if bf is None or not bf.fusable or not be.tiled or not be.fuses_labels:
            return False
        if be.key_itemsize is not None and keys.element_size() != be.key_itemsize:
            return False
        if self.digit_split is not None:
            return True               # the fused2 stages take the key strip only
        key = (self.backend, type(bf).__name__, self.m_eff)
        hit = _FUSION_CACHE.get(key)
        if hit is None:
            if isinstance(bf, BitfieldSpec):
                hit = (True, "radix BitfieldSpec: the digit is a shift and a mask, and a "
                             "chained radix sort moves no labels")
            elif be.uses_kernels:
                hit = (True, "kernel backend: the CUDA kernels compute the labels in registers")
            else:
                from repro_torch.core.pipeline import autotune as _at

                hit = _at.maybe_tune_fusion(self)          # pins on success
                if hit is None:
                    if _at.armed() and _at._IN_SEARCH:
                        # inside another axis's search: fuse without pinning,
                        # so the shape can still be measured later
                        return True
                    hit = (True, (
                        f"m_eff={self.m_eff}: the plain stage bodies fuse every fusable spec; "
                        f"the JAX ceiling (VMAP_FUSION_MAX_BUCKETS = 512) was measured with jnp "
                        f"on a CPU host and is not the port's; set_autotune measures the choice"
                    ))
            _FUSION_CACHE[key] = hit
        return hit[0]

    def _host_labels(self, keys: Tensor) -> Tensor:
        """The single label-materialisation door: a ``CallableSpec`` plan,
        or off-width keys in a partial mode. The spec runs on the keys'
        device; its labels come back as a contiguous int32 strip there (a
        user's function may return int64 or a strided view), and labels on
        another device are refused rather than copied."""
        spec = self.ids_fn()
        ids = spec(keys)
        if tuple(ids.shape) != tuple(keys.shape) or ids.device != keys.device:
            raise ValueError(
                f"bucket function {spec.name!r} returned labels of shape {tuple(ids.shape)} on "
                f"{ids.device} for keys of shape {tuple(keys.shape)} on {keys.device}"
            )
        return ids.to(torch.int32).contiguous()

    def _check_key_width(self, keys: Tensor) -> None:
        """Kernel backends take 32-bit words, but keys enter the kernels
        only when the pipeline reorders them. In the partial modes off-width
        keys turn label fusion off: their labels are materialised and the
        kernels see int32 ids alone."""
        if self.mode == "reorder":
            get_backend(self.backend).check_keys(keys)

    def pad_key(self, dtype: torch.dtype):
        """A key whose bucket is m−1: the layout's pad sentinel."""
        return self.ids_fn().pad_key(dtype)

    def stages(self) -> Tuple[str, ...]:
        """The stage graph as ``name:impl`` strings. Fused-label stages
        assume keys of the backend's width: off-width keys in a partial
        mode take the materialised-label stages at call time, which the
        shape-free plan cannot show. Packed plans carry a ``-packed``
        suffix on their local-solve stages, but for the vmap
        ``counts_only`` prescan, a plain scatter-add on either family.
        Fused-pair plans carry the JAX package's ``fused2-pair`` tags with
        the family spelled out."""
        be = get_backend(self.backend)
        eng = "kernel" if be.uses_kernels else "vmap"
        if self.digit_split is not None:
            fam = f"-{self.family}"
            pre = f"prescan:fused2-pair-{eng}"
            positions = f"postscan:fused2-pair-positions-{eng}{fam}"
            post = (positions if self.method == "dms"
                    else f"postscan:fused2-pair-reorder-{eng}{fam}")
            if self.mode == "counts_only":
                base = (pre, "reduce:counts")
            elif self.mode == "positions_only":
                base = (pre, "scan:global", positions)
            else:
                base = (pre, "scan:global", post, "scatter:bucket-major")
            return self._with_layout(base)
        fused = self.bucket_fn is not None and self.bucket_fn.fusable
        lab = "fused-label-" if fused else ""
        fam = "-packed" if be.tiled and self.family == "packed" else ""
        pre_fam = fam if be.uses_kernels or self.mode != "counts_only" else ""
        pre = f"prescan:{lab}{eng}{pre_fam}"
        positions = f"postscan:{lab}positions-{eng}{fam}"
        post = positions if self.method == "dms" else (
            f"postscan:fused-label-reorder-{eng}{fam}" if fused
            else f"postscan:fused-reorder-{eng}{fam}")
        if not be.tiled:
            base = ("direct-solve:reference",)
        elif self.mode == "counts_only":
            base = (pre, "reduce:counts")
        elif self.mode == "positions_only":
            base = (pre, "scan:global", positions)
        else:
            base = (pre, "scan:global", post, "scatter:bucket-major")
        return self._with_layout(base)

    def stage_graph(self) -> Tuple[Stage, ...]:
        """:meth:`stages` as :class:`Stage` nodes."""
        return tuple(Stage(*s.partition(":")[::2]) for s in self.stages())


@dataclasses.dataclass(frozen=True)
class MultisplitPlan(PipelineSpec):
    """An executable :class:`PipelineSpec`: call it with tensors."""

    def prescan(
        self, keys_tiled: Optional[Tensor], ids_tiled: Optional[Tensor],
        seg_tiled: Optional[Tensor] = None,
    ) -> Tensor:
        """Stage 1: per-tile (combined) bucket histograms H (L, m_eff)."""
        return get_backend(self.backend).stages.prescan(self, keys_tiled, ids_tiled, seg_tiled)

    def postscan(
        self, g: Tensor, keys_tiled: Tensor, ids_tiled: Optional[Tensor],
        vals_tiled: Optional[Tensor], seg_tiled: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
        """Stage 3: (scatter_src_keys, scatter_src_vals, scatter_pos, perm).
        For wms/bms the sources are (segment,) bucket-major within each
        tile; ``perm`` is the element-order destination (paper eq. (2))."""
        impl = get_backend(self.backend).stages
        if self.method == "dms":
            pos = impl.positions(self, g, keys_tiled, ids_tiled, seg_tiled)
            return keys_tiled, vals_tiled, pos, pos
        return impl.reorder(self, g, keys_tiled, ids_tiled, vals_tiled, seg_tiled)

    def run_tiled(
        self, keys_tiled: Tensor, ids_tiled: Optional[Tensor] = None,
        vals_tiled: Optional[Tensor] = None, seg_tiled: Optional[Tensor] = None,
        rows: Optional[int] = None,
    ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
        """One {prescan, scan, postscan, scatter} sweep over PRE-TILED
        buffers, at the full padded length: ``(keys_pad, vals_pad, hist,
        perm_tiled)``, the data as ``(rows, n_row)`` rows with ``rows=b``
        (the batched layout: a scan per row, destinations row-local, one
        flat scatter at ``row·n_row + pos``). The chained radix pipeline
        iterates this. The (segment, bucket)-major order of a segmented
        sweep is the concatenation of every segment's bucket-major order,
        so the same flat scatter lands each segment in its input span."""
        hist = self.prescan(keys_tiled, ids_tiled, seg_tiled)
        g = _st.global_scan(hist, rows or 1)
        src_keys, src_vals, pos, perm_tiled = self.postscan(
            g, keys_tiled, ids_tiled, vals_tiled, seg_tiled)
        n_total = keys_tiled.numel()
        idx = pos.reshape(-1).long() if rows is None else _st.row_index(pos, rows)
        keys_pad = _st.scatter(src_keys, idx, n_total)
        vals_pad = _st.scatter(src_vals, idx, n_total) if vals_tiled is not None else None
        if rows is not None:
            keys_pad = keys_pad.view(rows, -1)
            vals_pad = vals_pad.view(rows, -1) if vals_pad is not None else None
        return keys_pad, vals_pad, hist, perm_tiled

    def _empty_result(self, keys: Tensor, values: Optional[Tensor]) -> MultisplitResult:
        """n == 0: every output empty or zero, in the layout's shapes."""
        lead = self.batch if self.batch is not None else self.segments
        shape = (self.num_buckets,) if lead is None else (lead, self.num_buckets)
        zeros = torch.zeros(shape, dtype=torch.int32, device=keys.device)
        perm_shape = (0,) if self.batch is None else (self.batch, 0)
        perm = torch.zeros(perm_shape, dtype=torch.int32, device=keys.device)
        if self.mode == "counts_only":
            return MultisplitResult(None, None, zeros, zeros, None)
        if self.mode == "positions_only":
            return MultisplitResult(None, None, zeros, zeros, perm)
        return MultisplitResult(keys, values, zeros, zeros, perm)

    def _segment_ids(self, keys: Tensor, segment_starts) -> Tuple[Optional[Tensor], Optional[Tensor]]:
        """(starts, seg_ids) on the keys' device, or (None, None) for a flat
        plan."""
        if self.segments is None:
            if segment_starts is not None:
                raise ValueError("plan is not segmented; segment_starts not accepted")
            return None, None
        if segment_starts is None:
            raise ValueError("segmented plan requires segment_starts")
        starts = torch.as_tensor(segment_starts).to(device=keys.device, dtype=torch.int32)
        if tuple(starts.shape) != (self.segments,):
            raise ValueError(
                f"plan resolved for {self.segments} segments, got segment_starts shape "
                f"{tuple(starts.shape)}"
            )
        return starts, _st.segment_ids_from_starts(starts, self.n)

    def __call__(
        self, keys: Tensor, values: Optional[Tensor] = None, segment_starts=None,
    ) -> MultisplitResult:
        if (values is not None) != self.key_value:
            raise ValueError(
                f"plan resolved for key_value={self.key_value} but called with "
                f"values={'present' if values is not None else 'absent'}"
            )
        if self.batch is not None:
            if segment_starts is not None:
                raise ValueError("plan is not segmented; segment_starts not accepted")
            return self._call_batched(keys, values)
        if keys.dim() != 1 or keys.shape[0] != self.n:
            raise ValueError(f"plan resolved for keys of shape ({self.n},), got {tuple(keys.shape)}")
        if values is not None and values.shape != keys.shape:
            raise ValueError(f"values must have shape {tuple(keys.shape)}, got {tuple(values.shape)}")
        starts, seg_ids = self._segment_ids(keys, segment_starts)
        if self.n == 0:
            return self._empty_result(keys, values)
        be = get_backend(self.backend)
        if not be.tiled:
            return self._call_direct(keys, values, seg_ids, starts)

        self._check_key_width(keys)
        keys = keys.contiguous()
        m, s, n, tile = self.num_buckets, self.segments, self.n, self.tile
        m_eff = self.m_eff

        # ---- layout: pads ride in (segment s-1,) bucket m-1 at the very tail
        if self.label_fusion(keys):
            keys_p, _ = _st.pad_to_tiles(keys, tile, self.pad_key(keys.dtype))
            keys_tiled, ids_tiled = keys_p.view(-1, tile), None
        else:
            ids_p, _ = _st.pad_to_tiles(self._host_labels(keys), tile, m - 1)
            ids_tiled = ids_p.view(-1, tile)
            keys_tiled = None
            if self.mode == "reorder":
                keys_tiled = _st.pad_to_tiles(keys, tile, 0)[0].view(-1, tile)
        seg_tiled = None
        if s is not None:
            seg_tiled = _st.pad_to_tiles(seg_ids, tile, s - 1)[0].view(-1, tile)
        n_total = (keys_tiled if keys_tiled is not None else ids_tiled).numel()
        vals_tiled = None
        if values is not None:
            vals_tiled = _st.pad_to_tiles(values.contiguous(), tile, 0)[0].view(-1, tile)

        def finalize_counts(hist: Tensor) -> Tensor:
            counts = hist.sum(0, dtype=torch.int32)
            counts[m_eff - 1] -= n_total - n                    # drop pad sentinels
            return counts if s is None else counts.view(s, m)

        def local(perm: Tensor) -> Tensor:
            """Segment-local destinations: perm - starts[seg]."""
            return perm if s is None else perm - starts.index_select(0, seg_ids)

        if self.mode == "counts_only":
            counts = finalize_counts(self.prescan(keys_tiled, ids_tiled, seg_tiled))
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts, None)

        if self.mode == "positions_only":
            hist = self.prescan(keys_tiled, ids_tiled, seg_tiled)
            pos = be.stages.positions(self, _st.global_scan(hist), keys_tiled, ids_tiled, seg_tiled)
            counts = finalize_counts(hist)
            return MultisplitResult(
                None, None, _st.exclusive_rows(counts), counts, local(pos.reshape(-1)[:n])
            )

        keys_pad, vals_pad, hist, perm_tiled = self.run_tiled(
            keys_tiled, ids_tiled, vals_tiled, seg_tiled)
        counts = finalize_counts(hist)
        return MultisplitResult(
            keys_pad[:n], vals_pad[:n] if values is not None else None,
            _st.exclusive_rows(counts), counts, local(perm_tiled.reshape(-1)[:n]),
        )

    def _call_batched(self, keys: Tensor, values: Optional[Tensor]) -> MultisplitResult:
        """Every row of ``(b, n)`` keys multisplit on its own: one grid of
        ``b·l_b`` tiles a stage, a scan per row, one scatter. The untiled
        reference solves row by row, as ``jax.vmap`` of the flat solve."""
        b, n, m = self.batch, self.n, self.num_buckets
        if tuple(keys.shape) != (b, n):
            raise ValueError(f"batched plan resolved for shape {(b, n)}, got {tuple(keys.shape)}")
        if values is not None and tuple(values.shape) != (b, n):
            raise ValueError(
                f"batched plans require values of shape {(b, n)}, got {tuple(values.shape)}"
            )
        if n == 0:
            return self._empty_result(keys, values)
        be = get_backend(self.backend)
        if not be.tiled:
            flat = dataclasses.replace(self, batch=None)
            per_row = [flat(keys[r], None if values is None else values[r]) for r in range(b)]
            return MultisplitResult(*(
                None if field[0] is None else torch.stack(field) for field in zip(*per_row)))

        self._check_key_width(keys)
        tile = self.tile
        l_b = -(-n // tile)                       # tiles a row
        n_row = l_b * tile

        # each tile belongs to ONE row: a grid of b·l_b tiles covers the batch
        if self.label_fusion(keys):
            keys_tiled = _st.pad_rows(keys, n_row, self.pad_key(keys.dtype)).view(-1, tile)
            ids_tiled = None
        else:
            ids_tiled = _st.pad_rows(self._host_labels(keys), n_row, m - 1).view(-1, tile)
            keys_tiled = None
            if self.mode == "reorder":
                keys_tiled = _st.pad_rows(keys, n_row, 0).view(-1, tile)
        vals_tiled = None
        if values is not None:
            vals_tiled = _st.pad_rows(values, n_row, 0).view(-1, tile)

        def finalize_counts(hist: Tensor) -> Tensor:
            counts = hist.view(b, l_b, m).sum(1, dtype=torch.int32)
            counts[:, m - 1] -= n_row - n                       # drop each row's pads
            return counts

        if self.mode == "counts_only":
            counts = finalize_counts(self.prescan(keys_tiled, ids_tiled))
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts, None)

        if self.mode == "positions_only":
            hist = self.prescan(keys_tiled, ids_tiled)
            pos = be.stages.positions(self, _st.global_scan(hist, b), keys_tiled, ids_tiled, None)
            counts = finalize_counts(hist)
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts,
                                    pos.view(b, n_row)[:, :n])

        keys_rows, vals_rows, hist, perm_tiled = self.run_tiled(
            keys_tiled, ids_tiled, vals_tiled, rows=b)
        counts = finalize_counts(hist)
        return MultisplitResult(
            keys_rows[:, :n], vals_rows[:, :n] if values is not None else None,
            _st.exclusive_rows(counts), counts, perm_tiled.view(b, n_row)[:, :n],
        )

    def _call_direct(
        self, keys: Tensor, values: Optional[Tensor], seg_ids: Optional[Tensor],
        starts: Optional[Tensor],
    ) -> MultisplitResult:
        """The untiled oracle: paper eq. (1) over the whole input, on the
        combined id ``seg·m + b`` for segmented plans, with the local solve
        of the plan's family (one-hot, or the packed direct solve)."""
        m, s = self.num_buckets, self.segments
        ids = self.ids_fn()(keys)
        if s is not None:
            ids = seg_ids * m + ids
        if self.mode == "counts_only":
            counts = _st.direct_counts(ids, self.m_eff)
            if s is not None:
                counts = counts.view(s, m)
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts, None)
        solve = _st.packed_direct_solve_ids if self.family == "packed" else _st.direct_solve_ids
        res = solve(keys, ids, self.m_eff, values)
        if s is not None:
            counts = res.bucket_counts.view(s, m)
            res = MultisplitResult(
                res.keys, res.values, _st.exclusive_rows(counts), counts,
                res.permutation - starts.index_select(0, seg_ids),
            )
        if self.mode == "positions_only":
            return MultisplitResult(
                None, None, res.bucket_starts, res.bucket_counts, res.permutation
            )
        return res


def _validate(method: str, backend: str, mode: str, key_value: bool) -> None:
    if method not in ("dms", "wms", "bms"):
        raise ValueError(f"unknown multisplit method {method!r}")
    get_backend(backend)                  # raises ValueError on unknown names
    if mode not in MODES:
        raise ValueError(f"unknown pipeline mode {mode!r}; expected one of {MODES}")
    if mode != "reorder" and key_value:
        raise ValueError(f"mode={mode!r} never touches values; resolve with key_value=False")


def _validate_layout(batch: Optional[int], segments: Optional[int]) -> None:
    if batch is not None and segments is not None:
        raise ValueError("batch and segments are mutually exclusive plan layouts")
    if batch is not None and batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if segments is not None and segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")


def _validate_digit_split(digit_split: Optional[int], bucket_fn, backend: str) -> None:
    """The JAX package's rules and messages (``spec.py:727-750``)."""
    if digit_split is None:
        return
    be = get_backend(backend)
    if not be.tiled or not be.fuses_digits:
        raise ValueError(
            f"backend {backend!r} does not fuse digit pairs (fuses_digits="
            f"False); run the pair as a plain combined-digit plan instead"
        )
    if not isinstance(bucket_fn, BitfieldSpec):
        raise ValueError(
            "digit_split requires the combined-pair BitfieldSpec bucket_fn "
            f"(got {type(bucket_fn).__name__})"
        )
    if not 0 < digit_split < bucket_fn.bits:
        raise ValueError(
            f"digit_split must split the pair strictly (0 < split < bits); "
            f"got split={digit_split}, bits={bucket_fn.bits}"
        )


def make_plan(
    n: int,
    num_buckets: int,
    *,
    method: str = "bms",
    key_value: bool = False,
    backend: str = "vmap",
    tile: Optional[int] = None,
    bucket_fn: Optional[BucketSpec] = None,
    batch: Optional[int] = None,
    segments: Optional[int] = None,
    mode: str = "reorder",
    family: Optional[str] = None,
    digit_split: Optional[int] = None,
    sub_bits: Optional[int] = None,
) -> MultisplitPlan:
    """Resolve (n, m, method, key-value-ness, backend, mode) into a staged
    plan: flat, batched over ``(b, n)`` keys with ``batch=b``, or segmented
    with ``segments=s`` (call it with an ``(s,)`` ``segment_starts``); the
    two layouts are mutually exclusive. ``digit_split=r`` makes ``bucket_fn``, a
    BitfieldSpec, a fused two-digit pair whose low digit is r bits wide:
    its family is decided at the stage width ``2^r·s`` and its tile at the
    pair's width, both with a digits slot (``tiles.py``); ``sub_bits`` pins
    its in-tile stage width."""
    _validate_layout(batch, segments)
    _validate(method, backend, mode, key_value)
    if bucket_fn is not None:
        bucket_fn = as_spec(bucket_fn)
        if bucket_fn.num_buckets != num_buckets:
            raise ValueError(
                f"num_buckets={num_buckets} but the spec has {bucket_fn.num_buckets}"
            )
    _validate_digit_split(digit_split, bucket_fn, backend)
    m_eff = num_buckets * (segments or 1)
    digits, stage_m = 1, None
    if digit_split is not None:
        digits, stage_m = 2, (1 << digit_split) * (segments or 1)
    # the family first: an armed autotuner's family miss pins the tile too
    resolved = resolve_kernel_family(n, stage_m or m_eff, method, backend, family, digits,
                                     key_value=key_value,
                                     pair_m=None if digit_split is None else m_eff)
    return MultisplitPlan(
        n=n, num_buckets=num_buckets, method=method, key_value=key_value,
        backend=backend,
        tile=resolve_tile(n, m_eff, method, key_value, backend, tile, digits, stage_m,
                          family=family),
        bucket_fn=bucket_fn, batch=batch, segments=segments, mode=mode,
        family=resolved, digit_split=digit_split,
        sub_bits=None if digit_split is None else resolve_sub_bits(
            n, m_eff, method, key_value, backend, stage_m, sub_bits),
    )


def make_radix_plan(
    n: int,
    shift: int,
    bits: int,
    *,
    method: str = "bms",
    key_value: bool = False,
    backend: str = "vmap",
    tile: Optional[int] = None,
    batch: Optional[int] = None,
    segments: Optional[int] = None,
    mode: str = "reorder",
    family: Optional[str] = None,
    digit_split: Optional[int] = None,
    sub_bits: Optional[int] = None,
) -> MultisplitPlan:
    """A plan whose bucket spec is the radix digit BitfieldSpec(shift, bits);
    ``digit_split=r`` makes it a fused two-digit pair (low digit r bits
    wide) and ``sub_bits`` pins the pair's in-tile stage width."""
    return make_plan(
        n, 1 << bits, method=method, key_value=key_value, backend=backend,
        tile=tile, bucket_fn=BitfieldSpec(shift, bits), batch=batch, segments=segments,
        mode=mode, family=family, digit_split=digit_split, sub_bits=sub_bits,
    )


def make_batched_plan(batch: int, n: int, num_buckets: int, **kw) -> MultisplitPlan:
    """Batched plan over ``(batch, n)`` keys: one launch a stage for all
    rows."""
    return make_plan(n, num_buckets, batch=batch, **kw)


def make_segmented_plan(n: int, num_segments: int, num_buckets: int, **kw) -> MultisplitPlan:
    """Segmented plan over flat ``(n,)`` keys with ``num_segments`` ragged
    segments (call it with ``segment_starts=``): one launch a stage for all
    segments."""
    return make_plan(n, num_buckets, segments=num_segments, **kw)


def make_segmented_radix_plan(
    n: int, num_segments: int, shift: int, bits: int, **kw
) -> MultisplitPlan:
    """Segmented radix plan: one digit pass over all segments."""
    return make_radix_plan(n, shift, bits, segments=num_segments, **kw)
