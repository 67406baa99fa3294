"""PipelineSpec and the executable plan of the FLAT layout: the stage graph
of the multisplit pipeline (paper §4.1), with partial-pipeline modes.
Counterpart of ``repro/core/pipeline/spec.py:550-664``.

``mode`` selects how much of the pipeline runs:

* ``reorder`` (default): {prescan, scan, postscan(+reorder), scatter} —
  stable bucket-major output;
* ``counts_only``: {prescan, reduce} — the paper's §7.3 histogram;
* ``positions_only``: {prescan, scan, postscan-positions} — the eq. (2)
  destinations without moving any key.

Pads ride in bucket m−1 at the tail: fused-label plans pad with the spec's
pad key (for the radix digit, the all-ones key, digit m−1 in every pass),
so pads land after every real element and ``finalize_counts`` takes them
out of the last bucket. The batched and segmented layouts are ROADMAP queue
A items 5 and 6.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.identifiers import BitfieldSpec, BucketSpec, as_spec
from repro_torch.core.pipeline import stages as _st
from repro_torch.core.pipeline.registry import get_backend
from repro_torch.core.pipeline.stages import MultisplitResult
from repro_torch.core.pipeline.tiles import resolve_kernel_family, resolve_tile

Tensor = torch.Tensor

MODES = ("reorder", "counts_only", "positions_only")


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """A declarative multisplit pipeline for one flat problem shape.

    Frozen and hashable by value (``bucket_fn`` is a value-hashable spec).
    Build it with :func:`make_plan` or :func:`make_radix_plan`."""

    n: int
    num_buckets: int
    method: str                     # dms | wms | bms
    key_value: bool
    backend: str
    tile: int
    bucket_fn: Optional[BucketSpec] = None
    mode: str = "reorder"
    family: str = "onehot"

    def ids_fn(self) -> BucketSpec:
        if self.bucket_fn is None:
            raise ValueError("plan has no bucket spec")
        return self.bucket_fn

    def label_fusion(self, keys: Tensor) -> bool:
        """Whether this call computes bucket ids inside the tile stage: a
        fusable spec on a label-fusing tiled backend, with keys of the
        backend's width."""
        bf = self.bucket_fn
        be = get_backend(self.backend)
        if bf is None or not bf.fusable or not be.tiled or not be.fuses_labels:
            return False
        return be.key_itemsize is None or keys.element_size() == be.key_itemsize

    def _host_labels(self, keys: Tensor) -> Tensor:
        """The single label-materialisation door (CallableSpec plans)."""
        return self.ids_fn()(keys)

    def pad_key(self, dtype: torch.dtype):
        """A key whose bucket is m−1: the layout's pad sentinel."""
        return self.ids_fn().pad_key(dtype)

    def stages(self) -> Tuple[str, ...]:
        """The stage graph as ``name:impl`` strings."""
        be = get_backend(self.backend)
        if not be.tiled:
            return ("direct-solve:reference",)
        eng = "kernel" if be.uses_kernels else "vmap"
        fused = self.bucket_fn is not None and self.bucket_fn.fusable
        lab = "fused-label-" if fused else ""
        pre = f"prescan:{lab}{eng}"
        positions = f"postscan:{lab}positions-{eng}"
        post = positions if self.method == "dms" else f"postscan:{lab}reorder-{eng}"
        if self.mode == "counts_only":
            return (pre, "reduce:counts")
        if self.mode == "positions_only":
            return (pre, "scan:global", positions)
        return (pre, "scan:global", post, "scatter:bucket-major")


@dataclasses.dataclass(frozen=True)
class MultisplitPlan(PipelineSpec):
    """An executable :class:`PipelineSpec`: call it with tensors."""

    def prescan(self, keys_tiled: Optional[Tensor], ids_tiled: Optional[Tensor]) -> Tensor:
        """Stage 1: per-tile bucket histograms H (L, m)."""
        return get_backend(self.backend).stages.prescan(self, keys_tiled, ids_tiled)

    def postscan(
        self, g: Tensor, keys_tiled: Tensor, ids_tiled: Optional[Tensor],
        vals_tiled: Optional[Tensor],
    ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
        """Stage 3: (scatter_src_keys, scatter_src_vals, scatter_pos, perm).
        For wms/bms the sources are bucket-major within each tile; ``perm``
        is the element-order destination (paper eq. (2))."""
        impl = get_backend(self.backend).stages
        if self.method == "dms":
            pos = impl.positions(self, g, keys_tiled, ids_tiled)
            return keys_tiled, vals_tiled, pos, pos
        return impl.reorder(self, g, keys_tiled, ids_tiled, vals_tiled)

    def run_tiled(
        self, keys_tiled: Tensor, ids_tiled: Optional[Tensor] = None,
        vals_tiled: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Optional[Tensor], Tensor, Tensor]:
        """One {prescan, scan, postscan, scatter} sweep over PRE-TILED
        buffers, at the full padded length: ``(keys_pad, vals_pad, hist,
        perm_tiled)``. The chained radix pipeline iterates this."""
        hist = self.prescan(keys_tiled, ids_tiled)
        g = _st.global_scan(hist)
        src_keys, src_vals, pos, perm_tiled = self.postscan(g, keys_tiled, ids_tiled, vals_tiled)
        n_total, idx = keys_tiled.numel(), pos.reshape(-1).long()
        keys_pad = _st.scatter(src_keys, idx, n_total)
        vals_pad = _st.scatter(src_vals, idx, n_total) if vals_tiled is not None else None
        return keys_pad, vals_pad, hist, perm_tiled

    def _empty_result(self, keys: Tensor, values: Optional[Tensor]) -> MultisplitResult:
        zeros = torch.zeros((self.num_buckets,), dtype=torch.int32, device=keys.device)
        perm = torch.zeros((0,), dtype=torch.int32, device=keys.device)
        if self.mode == "counts_only":
            return MultisplitResult(None, None, zeros, zeros, None)
        if self.mode == "positions_only":
            return MultisplitResult(None, None, zeros, zeros, perm)
        return MultisplitResult(keys, values, zeros, zeros, perm)

    def __call__(self, keys: Tensor, values: Optional[Tensor] = None) -> MultisplitResult:
        if (values is not None) != self.key_value:
            raise ValueError(
                f"plan resolved for key_value={self.key_value} but called with "
                f"values={'present' if values is not None else 'absent'}"
            )
        if keys.dim() != 1 or keys.shape[0] != self.n:
            raise ValueError(f"plan resolved for keys of shape ({self.n},), got {tuple(keys.shape)}")
        if values is not None and values.shape != keys.shape:
            raise ValueError(f"values must have shape {tuple(keys.shape)}, got {tuple(values.shape)}")
        if self.n == 0:
            return self._empty_result(keys, values)
        be = get_backend(self.backend)
        if not be.tiled:
            return self._call_direct(keys, values)

        if be.uses_kernels or self.mode == "reorder":
            be.check_keys(keys)
        keys = keys.contiguous()
        m, n, tile = self.num_buckets, self.n, self.tile

        # ---- layout: pads ride in bucket m-1 at the very tail
        if self.label_fusion(keys):
            keys_p, _ = _st.pad_to_tiles(keys, tile, self.pad_key(keys.dtype))
            keys_tiled, ids_tiled = keys_p.view(-1, tile), None
        else:
            ids_p, _ = _st.pad_to_tiles(self._host_labels(keys), tile, m - 1)
            ids_tiled = ids_p.view(-1, tile)
            keys_tiled = None
            if self.mode == "reorder":
                keys_tiled = _st.pad_to_tiles(keys, tile, 0)[0].view(-1, tile)
        n_total = (keys_tiled if keys_tiled is not None else ids_tiled).numel()
        vals_tiled = None
        if values is not None:
            vals_tiled = _st.pad_to_tiles(values.contiguous(), tile, 0)[0].view(-1, tile)

        def finalize_counts(hist: Tensor) -> Tensor:
            counts = hist.sum(0, dtype=torch.int32)
            counts[m - 1] -= n_total - n                        # drop pad sentinels
            return counts

        if self.mode == "counts_only":
            counts = finalize_counts(self.prescan(keys_tiled, ids_tiled))
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts, None)

        if self.mode == "positions_only":
            hist = self.prescan(keys_tiled, ids_tiled)
            pos = be.stages.positions(self, _st.global_scan(hist), keys_tiled, ids_tiled)
            counts = finalize_counts(hist)
            return MultisplitResult(
                None, None, _st.exclusive_rows(counts), counts, pos.reshape(-1)[:n]
            )

        keys_pad, vals_pad, hist, perm_tiled = self.run_tiled(keys_tiled, ids_tiled, vals_tiled)
        counts = finalize_counts(hist)
        return MultisplitResult(
            keys_pad[:n], vals_pad[:n] if values is not None else None,
            _st.exclusive_rows(counts), counts, perm_tiled.reshape(-1)[:n],
        )

    def _call_direct(self, keys: Tensor, values: Optional[Tensor]) -> MultisplitResult:
        """The untiled oracle: paper eq. (1) over the whole input."""
        m = self.num_buckets
        ids = self.ids_fn()(keys)
        if self.mode == "counts_only":
            counts = _st.direct_counts(ids, m)
            return MultisplitResult(None, None, _st.exclusive_rows(counts), counts, None)
        res = _st.direct_solve_ids(keys, ids, m, values)
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
) -> MultisplitPlan:
    """Resolve (n, m, method, key-value-ness, backend, mode) into a flat
    staged plan."""
    if batch is not None:
        raise NotImplementedError("the batched layout (batch=) is ROADMAP queue A item 5")
    if segments is not None:
        raise NotImplementedError("the segmented layout (segments=) is ROADMAP queue A item 6")
    _validate(method, backend, mode, key_value)
    if bucket_fn is not None:
        bucket_fn = as_spec(bucket_fn)
        if bucket_fn.num_buckets != num_buckets:
            raise ValueError(
                f"num_buckets={num_buckets} but the spec has {bucket_fn.num_buckets}"
            )
        if get_backend(backend).uses_kernels and not bucket_fn.fusable:
            raise NotImplementedError(
                f"backend {backend!r} computes labels in-kernel; the {type(bucket_fn).__name__} "
                f"needs the ids-strip kernels, ROADMAP queue B item 7 (use backend='vmap')"
            )
    return MultisplitPlan(
        n=n, num_buckets=num_buckets, method=method, key_value=key_value,
        backend=backend, tile=resolve_tile(n, num_buckets, method, key_value, backend, tile),
        bucket_fn=bucket_fn, mode=mode,
        family=resolve_kernel_family(n, num_buckets, method, backend, family),
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
    mode: str = "reorder",
    family: Optional[str] = None,
) -> MultisplitPlan:
    """A plan whose bucket spec is the radix digit BitfieldSpec(shift, bits)."""
    return make_plan(
        n, 1 << bits, method=method, key_value=key_value, backend=backend,
        tile=tile, bucket_fn=BitfieldSpec(shift, bits), mode=mode, family=family,
    )
