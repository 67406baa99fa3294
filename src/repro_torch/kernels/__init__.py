"""Hopper kernels of the port (CUDA C++ in ``csrc/``, built at first use by
:mod:`repro_torch.kernels.build`) and their plain PyTorch versions. Importing
this package builds nothing and needs no card.

This module is the one registry of the kernel wrappers: :data:`KERNELS`,
the Pallas function each replaces (:data:`PALLAS_TWIN`, :func:`replaces`)
and their launch counts (:func:`reset_launches`, :func:`launch_counts`)."""

# Each kernel wrapper ("module.function" under repro_torch/kernels/) -> the
# Pallas function it replaces ("file:line:function" under src/repro/kernels/,
# the line of its ``def``). Plain strings, so nothing of the JAX package is
# imported; tests/test_torch_kernel_doors.py holds them against the JAX sources.
PALLAS_TWIN = {
    "multisplit_tile.spec_tile_histograms": "multisplit_tile.py:368:spec_tile_histograms_pallas",
    "multisplit_tile.spec_fused_postscan_reorder":
        "multisplit_tile.py:460:spec_fused_postscan_reorder_pallas",
    "multisplit_tile.spec_tile_positions": "multisplit_tile.py:396:spec_tile_positions_pallas",
    "multisplit_tile.seg_spec_tile_histograms":
        "multisplit_tile.py:512:seg_spec_tile_histograms_pallas",
    "multisplit_tile.seg_spec_fused_postscan_reorder":
        "multisplit_tile.py:587:seg_spec_fused_postscan_reorder_pallas",
    "multisplit_tile.seg_spec_tile_positions":
        "multisplit_tile.py:544:seg_spec_tile_positions_pallas",
    "multisplit_tile.tile_histograms": "multisplit_tile.py:94:tile_histograms_pallas",
    "multisplit_tile.fused_postscan_reorder": "multisplit_tile.py:168:fused_postscan_reorder_pallas",
    "multisplit_tile.tile_positions": "multisplit_tile.py:123:tile_positions_pallas",
    "multisplit_tile.seg_tile_histograms": "multisplit_tile.py:227:seg_tile_histograms_pallas",
    "multisplit_tile.seg_fused_postscan_reorder":
        "multisplit_tile.py:303:seg_fused_postscan_reorder_pallas",
    "multisplit_tile.seg_tile_positions": "multisplit_tile.py:259:seg_tile_positions_pallas",
    "multisplit_tile.spec_bucket_ids": "multisplit_tile.py:421:spec_bucket_ids_pallas",
    "multisplit_tile.packed_tile_histograms":
        "multisplit_tile.py:662:packed_tile_histograms_pallas",
    "multisplit_tile.packed_fused_postscan_reorder":
        "multisplit_tile.py:772:packed_fused_postscan_reorder_pallas",
    "multisplit_tile.packed_tile_positions": "multisplit_tile.py:706:packed_tile_positions_pallas",
    "multisplit_tile.fused2_tile_histograms":
        "multisplit_tile.py:863:fused2_tile_histograms_pallas",
    "multisplit_tile.fused2_fused_postscan_reorder":
        "multisplit_tile.py:973:fused2_fused_postscan_reorder_pallas",
    "multisplit_tile.fused2_tile_positions": "multisplit_tile.py:909:fused2_tile_positions_pallas",
    "multisplit_tile.tile_reorder": "multisplit_tile.py:1061:tile_reorder_pallas",
    "flash_attention.flash_attention": "flash_attention.py:76:flash_attention_pallas",
}

# the wrapper modules import this package's build module, so they come after
# the table; neither imports anything back from here
from repro_torch.kernels import flash_attention, multisplit_tile  # noqa: E402

_MODULES = {"multisplit_tile": multisplit_tile, "flash_attention": flash_attention}
# every kernel wrapper, in the order of PALLAS_TWIN
KERNELS = tuple(getattr(_MODULES[mod], fn)
                for mod, fn in (name.split(".") for name in PALLAS_TWIN))


def replaces(name: str) -> str:
    """``"src/repro/kernels/<file>:<line>"`` of the Pallas function that the
    wrapper called ``name`` replaces."""
    (twin,) = [t for w, t in PALLAS_TWIN.items() if w.split(".")[1] == name]
    file, line, _ = twin.split(":")
    return f"src/repro/kernels/{file}:{line}"


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    """Wrapper name -> the launches counted since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()
