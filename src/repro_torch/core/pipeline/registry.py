"""Declarative backend registry of the multisplit pipeline (counterpart of
``repro/core/pipeline/registry.py``).

A :class:`Backend` bundles capability flags, which the stage graph consults
instead of matching backend names, with a :class:`StageImpl`: the
backend's prescan / postscan-positions / postscan-reorder over pre-tiled
``(L, T)`` buffers. Three backends are registered:

* ``reference`` — the O(n·m) direct solve, untiled: the oracle.
* ``vmap`` — tiled pure-torch stages (the plain in-tile bodies of
  :mod:`repro_torch.kernels.common`), the analogue of ``VmapStages``.
* ``cuda`` — the hand-written Hopper kernels K1-K3 (flat) and K1s-K3s
  (segmented), with labels in-kernel or read from a materialised ids strip
  (:mod:`repro_torch.kernels.ops`), and for the packed family K1p-K3p in
  all four of those forms. On CPU tensors the kernel wrappers run their
  plain versions; on CUDA tensors they launch the kernels or raise.

All three implement both kernel families, ``onehot`` and ``packed``
(``spec.family``), which give the same bits. The stages take any ``(L,
tile)`` grid: a batched plan's ``b·l_b`` tiles (each inside one row) run
through the same flat stages in one launch, so the batched layout needs
nothing here beyond the shapes. ``vmap`` and ``cuda`` also
fuse digit pairs (``fuses_digits``): a plan with a ``digit_split`` runs the
fused two-digit stages (K1f-K3f on the card, the fused2 plain bodies on
``vmap``) over the pair's ``BitfieldSpec``; the untiled ``reference``
keeps the single-digit schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import common as _body
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


class StageImpl:
    """Backend implementations of the local pipeline stages on PRE-TILED
    ``(L, tile)`` buffers. ``spec`` is the resolved
    :class:`~repro_torch.core.pipeline.spec.PipelineSpec`; ``ids_tiled is
    None`` selects fused labels (computed inside the stage from
    ``spec.bucket_fn``) and ``seg_tiled is not None`` the segmented layout
    (the combined id ``seg·m + b``)."""

    def prescan(self, spec, keys_tiled, ids_tiled, seg_tiled) -> Tensor:
        raise NotImplementedError

    def positions(self, spec, g, keys_tiled, ids_tiled, seg_tiled) -> Tensor:
        raise NotImplementedError

    def reorder(self, spec, g, keys_tiled, ids_tiled, vals_tiled, seg_tiled):
        raise NotImplementedError


class KernelStages(StageImpl):
    """The CUDA kernel stages: one block per tile. Fused labels (``ids_tiled
    is None``) are computed in-kernel from the plan's declarative spec
    (K1-K3, or K1s-K3s with a segment strip); a materialised ids strip (a
    ``CallableSpec`` plan, or off-width keys in a partial mode) goes to the
    ids kernels, flat or segmented. A packed plan takes one packed door a
    stage (K1p-K3p), which covers all four forms."""

    @staticmethod
    def _fused2_kw(spec) -> dict:
        return dict(spec=spec.bucket_fn, split=spec.digit_split, num_segments=spec.segments or 1,
                    family=spec.family, sub_bits=spec.sub_bits)

    def prescan(self, spec, keys_tiled, ids_tiled, seg_tiled):
        m, s = spec.num_buckets, spec.segments
        if spec.digit_split is not None:         # a fused two-digit pair
            return kops.fused2_tile_histograms(keys_tiled, seg_tiled, spec=spec.bucket_fn,
                                               num_segments=s or 1)
        if spec.family == "packed":
            fused = ids_tiled is None
            return kops.packed_tile_histograms(
                keys_tiled if fused else ids_tiled, seg_tiled, num_buckets=m,
                spec=spec.bucket_fn if fused else None, num_segments=s or 1)
        if ids_tiled is not None:
            if seg_tiled is not None:
                return kops.seg_tile_histograms(ids_tiled, seg_tiled, m, s)
            return kops.tile_histograms(ids_tiled, m)
        if seg_tiled is not None:
            return kops.seg_spec_tile_histograms(keys_tiled, seg_tiled, spec.bucket_fn, s)
        return kops.spec_tile_histograms(keys_tiled, spec.bucket_fn)

    def positions(self, spec, g, keys_tiled, ids_tiled, seg_tiled):
        m, s = spec.num_buckets, spec.segments
        if spec.digit_split is not None:
            return kops.fused2_tile_positions(keys_tiled, g, seg_tiled, **self._fused2_kw(spec))
        if spec.family == "packed":
            fused = ids_tiled is None
            return kops.packed_tile_positions(
                keys_tiled if fused else ids_tiled, g, seg_tiled, num_buckets=m,
                spec=spec.bucket_fn if fused else None, num_segments=s or 1)
        if ids_tiled is not None:
            if seg_tiled is not None:
                return kops.seg_tile_positions(ids_tiled, seg_tiled, g, m, s)
            return kops.tile_positions(ids_tiled, g, m)
        if seg_tiled is not None:
            return kops.seg_spec_tile_positions(keys_tiled, seg_tiled, g, spec.bucket_fn, s)
        return kops.spec_tile_positions(keys_tiled, g, spec.bucket_fn)

    def reorder(self, spec, g, keys_tiled, ids_tiled, vals_tiled, seg_tiled):
        m, s = spec.num_buckets, spec.segments
        if spec.digit_split is not None:
            return kops.fused2_fused_postscan_reorder(keys_tiled, g, vals_tiled, seg_tiled,
                                                      **self._fused2_kw(spec))
        if spec.family == "packed":
            fused = ids_tiled is None
            return kops.packed_fused_postscan_reorder(
                keys_tiled if fused else ids_tiled, g,
                keys_tiled=None if fused else keys_tiled, values_tiled=vals_tiled,
                seg_tiled=seg_tiled, num_buckets=m, spec=spec.bucket_fn if fused else None,
                num_segments=s or 1)
        if ids_tiled is not None:
            if seg_tiled is not None:
                return kops.seg_fused_postscan_reorder(
                    ids_tiled, seg_tiled, g, keys_tiled, vals_tiled, m, s)
            return kops.fused_postscan_reorder(ids_tiled, g, keys_tiled, vals_tiled, m)
        if seg_tiled is not None:
            return kops.seg_spec_fused_postscan_reorder(
                keys_tiled, seg_tiled, g, vals_tiled, spec.bucket_fn, s)
        return kops.spec_fused_postscan_reorder(keys_tiled, g, vals_tiled, spec.bucket_fn)


class VmapStages(StageImpl):
    """Tiled pure-torch stages: every tile's rank, histogram, starts and
    destinations from one one-hot cumsum (:func:`~repro_torch.kernels.
    common.tile_rank`). Segmented tiles take its carry form
    (:func:`~repro_torch.kernels.common.seg_tile_rank`) and a scatter-add
    histogram into s·m columns, O(T·m) whatever s. Fused-label plans derive
    the tile labels from ``spec.bucket_fn.emit`` inside the stage. Packed
    plans take the two-level packed rank (:func:`~repro_torch.kernels.
    common.packed_local_offsets`, the gather form), over the combined id
    ``seg·m + b`` when segmented, as the JAX ``VmapStages`` do; a
    ``counts_only`` prescan stays the plain scatter-add on either family.
    Fused-pair plans run the fused2 plain bodies over the pair's
    ``BitfieldSpec`` (:func:`~repro_torch.kernels.common.
    fused2_postscan_body`, in the plan's family)."""

    @staticmethod
    def _tile_ids(spec, keys_tiled, ids_tiled):
        return ids_tiled if ids_tiled is not None else spec.bucket_fn.emit(keys_tiled)

    @staticmethod
    def _packed_ids(spec, ids, seg_tiled):
        """(combined ids, packed layout) of a packed plan's tiles."""
        if seg_tiled is not None:
            ids = _body.combined_ids(ids, seg_tiled, spec.num_buckets)
        return ids, _body.packed_layout(ids.shape[1], spec.m_eff)

    @staticmethod
    def _fused2_kw(spec) -> dict:
        bf = spec.bucket_fn
        return dict(shift=bf.shift, split=spec.digit_split, bits=bf.bits,
                    num_segments=spec.segments or 1, family=spec.family, sub_bits=spec.sub_bits)

    def prescan(self, spec, keys_tiled, ids_tiled, seg_tiled):
        if spec.digit_split is not None:         # a fused two-digit pair
            bf = spec.bucket_fn
            return _body.fused2_counts_body(keys_tiled, bf.shift, bf.bits, seg_tiled,
                                            spec.segments or 1)
        ids = self._tile_ids(spec, keys_tiled, ids_tiled)
        if spec.family == "packed" and spec.mode != "counts_only":
            return _body.packed_counts(*self._packed_ids(spec, ids, seg_tiled))
        if seg_tiled is not None:
            return _body.seg_counts_body(ids, seg_tiled, spec.num_buckets, spec.segments)
        return _body.counts_body(ids, spec.num_buckets)

    def positions(self, spec, g, keys_tiled, ids_tiled, seg_tiled):
        if spec.digit_split is not None:
            return _body.fused2_positions_body(keys_tiled, g, seg=seg_tiled,
                                               **self._fused2_kw(spec))
        ids = self._tile_ids(spec, keys_tiled, ids_tiled)
        if spec.family == "packed":
            cid, layout = self._packed_ids(spec, ids, seg_tiled)
            return _body.packed_positions_body(cid, g, layout)
        if seg_tiled is not None:
            return _body.seg_positions_body(ids, seg_tiled, g, spec.num_buckets)
        return _body.positions_body(ids, g, spec.num_buckets)

    def reorder(self, spec, g, keys_tiled, ids_tiled, vals_tiled, seg_tiled):
        if spec.digit_split is not None:
            return _body.fused2_postscan_body(keys_tiled, g, vals_tiled, seg=seg_tiled,
                                              **self._fused2_kw(spec))
        ids = self._tile_ids(spec, keys_tiled, ids_tiled)
        if spec.family == "packed":
            cid, layout = self._packed_ids(spec, ids, seg_tiled)
            return _body.packed_postscan_body(cid, g, keys_tiled, vals_tiled, layout)
        if seg_tiled is not None:
            return _body.seg_postscan_body(ids, seg_tiled, g, keys_tiled, vals_tiled,
                                           spec.num_buckets, spec.segments)
        return _body.postscan_body(ids, g, keys_tiled, vals_tiled, spec.num_buckets)


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered execution target for the pipeline stage graph.

    ``tiled=False`` marks the direct-solve oracle (no tiling, no scan).
    ``fuses_labels`` advertises that fusable specs are evaluated inside the
    tile stage; ``fuses_digits`` that the stages run a fused two-digit pair
    (a plan's ``digit_split``); ``key_itemsize`` restricts the key width
    (the CUDA kernels take 32-bit words); ``families`` lists the kernel
    families the stages implement."""

    name: str
    description: str
    stages: Optional[StageImpl] = None
    tiled: bool = True
    uses_kernels: bool = False
    fuses_labels: bool = False
    fuses_digits: bool = False
    key_itemsize: Optional[int] = None
    families: Tuple[str, ...] = ("onehot",)

    def check_keys(self, keys: Tensor) -> None:
        if self.key_itemsize is not None and keys.element_size() != self.key_itemsize:
            raise ValueError(
                f"backend {self.name!r} requires {8 * self.key_itemsize}-bit keys "
                f"(got {keys.dtype}); use backend='vmap' for other widths"
            )


_REGISTRY: dict = {}


def register_backend(backend: Backend) -> Backend:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; expected one of {backend_names()}"
        ) from None


def available_backends() -> Tuple[Backend, ...]:
    """Every registered :class:`Backend`, in registration order."""
    return tuple(_REGISTRY.values())


def backend_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def resolve_backend(backend: Optional[str] = None) -> str:
    """A backend name, validated (``ValueError`` for an unknown one), or the
    port's default ``cuda``. The JAX package's ``(use_pallas, interpret)``
    knobs select among its Pallas backends and have no counterpart here."""
    return get_backend("cuda" if backend is None else backend).name


register_backend(Backend(
    name="reference",
    description="O(n·m) direct evaluation of paper eq. (1); the oracle",
    tiled=False,
    families=("onehot", "packed"),     # packed: the packed direct oracle
))
register_backend(Backend(
    name="vmap",
    description="tiled pure-torch stages (the plain in-tile bodies)",
    stages=VmapStages(),
    fuses_labels=True,
    fuses_digits=True,
    families=("onehot", "packed"),
))
register_backend(Backend(
    name="cuda",
    description="hand-written Hopper kernels, labels in-kernel or from an ids strip",
    stages=KernelStages(),
    uses_kernels=True,
    fuses_labels=True,
    fuses_digits=True,
    key_itemsize=4,
    families=("onehot", "packed"),
))

# The registered names, reference first: the JAX package's compatibility tuple.
BACKENDS = backend_names()
