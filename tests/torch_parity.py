"""Shared helpers for the parity tests between hybridrenderer_tpu (JAX,
the reference) and hybridrenderer_tpu_torch (the port): both packages
get the same arrays, passed through numpy."""
import dataclasses

import numpy as np

# reference env knobs that change its output; the parity tests clear them
REFERENCE_KNOBS = (
    "GBUFFER_FETCH", "RASTER_CLIP", "RASTER_EVAL", "RASTER_WALK",
    "RASTER_TPP", "RASTER_FLOOR_PROBE", "RASTER_ATTRW",
    "RASTER_DEADBLOCK_FIX", "RASTER_STREAM_GATHER", "RASTER_BIN_SORT",
    "RT_FUSE_SHADOW_AO", "SVGF_CHAIN_ORDER", "SVGF_TILE", "SHADE_FETCH",
    "SHADE_OCC_GATE", "GRAPH_NO_HISTORY", "WIDE_LEAF_TRIS", "WIDE_WIDTH",
    "HR_SLOT_MASK", "HR_TEX_BITS", "HR_TEX_SAMPLER", "HR_TEX_STUB",
)


def clear_reference_knobs(monkeypatch):
    for name in REFERENCE_KNOBS:
        monkeypatch.delenv(name, raising=False)


def flatten(obj):
    """JAX SceneData (nested dataclasses of arrays) → nested dicts of
    numpy arrays, the input of scene.convert.scene_from_numpy."""
    if dataclasses.is_dataclass(obj):
        return {f.name: flatten(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (bool, int, float, str, tuple)):
        return obj
    return np.asarray(obj)


def off_edge_errors(img_a, img_b, tri_id):
    """u8 images → (max error off triangle edges, p99 of all errors),
    the image gate of bench.py (edges: tri_boundary_mask, dilate 1)."""
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask

    diff = np.abs(img_a.astype(int) - img_b.astype(int))
    err = diff.max(axis=-1)
    off = err[~tri_boundary_mask(tri_id, dilate=1)]
    return (int(off.max()) if off.size else 0), float(np.percentile(diff, 99))
