"""Shared helpers for the parity tests between hybridrenderer_tpu (JAX,
the reference) and hybridrenderer_tpu_torch (the port): both packages
get the same arrays, passed through numpy."""
import contextlib
import dataclasses

import numpy as np
import torch

# reference env knobs that change its output; the parity tests clear them
REFERENCE_KNOBS = (
    "GBUFFER_FETCH", "RASTER_CLIP", "RASTER_EVAL", "RASTER_WALK",
    "RASTER_TPP", "RASTER_FLOOR_PROBE", "RASTER_ATTRW",
    "RASTER_DEADBLOCK_FIX", "RASTER_STREAM_GATHER", "RASTER_BIN_SORT",
    "RT_FUSE_SHADOW_AO", "SVGF_CHAIN_ORDER", "SVGF_TILE", "SHADE_FETCH",
    "SHADE_OCC_GATE", "GRAPH_NO_HISTORY", "WIDE_LEAF_TRIS", "WIDE_WIDTH",
    "HR_SLOT_MASK", "HR_TEX_BITS", "HR_TEX_SAMPLER", "HR_TEX_STUB",
    "FWD_STAGE", "OCC_LUM_EPS", "SHADE_OCC_FUSE", "RT_CLOSEST_PKT_ROWS",
)


def clear_reference_knobs(monkeypatch):
    for name in REFERENCE_KNOBS:
        monkeypatch.delenv(name, raising=False)


@contextlib.contextmanager
def one_torch_thread():
    """PyTorch's CPU ops on one thread for the block: the suite runs
    several test processes on the machine's cores, and a pool of threads
    per process contends for them (a 4 s frame took 90 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


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


def record_secondary_hits(renderer):
    """Wrap a port renderer's tracer so that each full-resolution
    radiance query (reflection, GI) records the triangle its rays hit,
    as an (H, W) numpy image: -1 on a miss, -2 where the ray is
    inactive. The returned function hands out the images recorded since
    its last call, in query order."""
    from hybridrenderer_tpu_torch.ops import trace_cuda
    from hybridrenderer_tpu_torch.ops.trace import RADIANCE_TMIN

    tracer, trace = renderer.tracer, renderer.tracer.trace_radiance
    H, W = renderer.settings.height, renderer.settings.width
    hits = []

    def recording(scene, origin, direction, ctx, depth=0, active=None):
        if origin.shape[:2] == (H, W):
            o, d, tmax, act = tracer.radiance_rays(origin, direction, active)
            _, tri, _, _ = trace_cuda.intersect_closest(
                tracer.packed, o, d, RADIANCE_TMIN, tmax, act)
            hits.append(np.where(act.cpu().numpy(), tri.cpu().numpy(),
                                 -2).reshape(H, W))
        return trace(scene, origin, direction, ctx, depth, active=active)

    tracer.trace_radiance = recording

    def take():
        out = hits[:]
        hits.clear()
        return out

    return take


def chain_bvh(T, device="cpu"):
    """(BVH, v0, v1, v2): T triangles facing the x axis in the planes x = 0 ..
    T - 1, in a tree whose internal nodes form one chain (depth T - 1):
    internal node i has the chain's next node (for i = T - 2, leaf T - 1)
    on the left and leaf i on the right; leaf k (node T - 1 + k) holds
    triangle k. Boxes are the exact unions, built bottom-up."""
    import torch

    from hybridrenderer_tpu_torch.ops.bvh import BVH

    x = np.arange(T, dtype=np.float32)[:, None]
    v0 = np.concatenate([x, np.full_like(x, -1.0), np.full_like(x, -1.0)], 1)
    v1 = np.concatenate([x, np.full_like(x, 2.0), np.full_like(x, -1.0)], 1)
    v2 = np.concatenate([x, np.full_like(x, -1.0), np.full_like(x, 2.0)], 1)
    N = 2 * T - 1
    left = np.full(N, -1, np.int32)
    right = np.full(N, -1, np.int32)
    tri = np.full(N, -1, np.int32)
    inner = np.arange(T - 1)
    left[inner] = inner + 1
    if T > 1:
        left[T - 2] = N - 1
    right[inner] = T - 1 + inner
    tri[T - 1:] = np.arange(T)
    nmin = np.zeros((N, 3), np.float32)
    nmax = np.zeros((N, 3), np.float32)
    nmin[T - 1:] = np.minimum(np.minimum(v0, v1), v2)
    nmax[T - 1:] = np.maximum(np.maximum(v0, v1), v2)
    for i in inner[::-1]:
        nmin[i] = np.minimum(nmin[left[i]], nmin[right[i]])
        nmax[i] = np.maximum(nmax[left[i]], nmax[right[i]])
    t = lambda a: torch.from_numpy(a).to(device)
    return (BVH(t(nmin), t(nmax), t(left), t(right), t(tri), num_tris=T),
            t(v0), t(v1), t(v2))


def heavy_tile_bins(width, height, entries, seed=0, device="cpu"):
    """K1 / K1v's inputs (records, tile_start, entry_cand) for an image
    of ``width`` x ``height`` pixels with one synthetic tile that lists
    ``entries`` candidates, beside a few small triangles elsewhere. The
    heavy tile's triangles lie inside it, in 12 shapes at flat depths;
    entry k repeats entry k - 128 exactly (equal exact depths across
    128-entry groups), and consecutive entries of a shape differ in
    depth by 2^-19 (near-ties that K1v's 2^-17 key settles by
    position). Candidate k is triangle k."""
    import torch

    from hybridrenderer_tpu_torch.ops import raster_cuda
    from hybridrenderer_tpu_torch.ops.raster import ClippedTriangles

    g = np.random.default_rng(seed)
    tx, ty = (width // 16) // 2, (height // 16) // 2
    x0, y0 = 16.0 * tx, 16.0 * ty
    shapes = x0 + g.uniform(0.0, 15.9, (12, 3, 2)).astype(np.float32)
    shapes[..., 1] += y0 - x0
    shapes[0] = [[x0, y0], [x0 + 15.9, y0], [x0, y0 + 15.9]]
    shapes[1] = [[x0 + 15.9, y0 + 15.9], [x0 + 15.9, y0], [x0, y0 + 15.9]]
    base_z = g.uniform(0.3, 0.9, 12).astype(np.float32)
    k = np.arange(entries) % 128
    shape = k % 12
    sxy = shapes[shape]
    z = base_z[shape] + (k // 12 % 3).astype(np.float32) * 2.0 ** -19
    # a few small triangles elsewhere, one tile each
    m = 40
    corner = g.uniform(0, [width - 6, height - 6], (m, 1, 2)).astype(
        np.float32)
    corner = np.floor(corner / 16.0) * 16.0
    # none in the heavy tile
    corner[..., 0] += np.where((corner[..., 0] == x0)
                               & (corner[..., 1] == y0), 16.0, 0.0)
    corner = corner + g.uniform(0, 10, (m, 1, 2))
    small = np.minimum(corner + g.uniform(0, 5, (m, 3, 2)),
                       [width - 0.5, height - 0.5]).astype(np.float32)
    sxy = np.concatenate([sxy, small]).astype(np.float32)
    z = np.concatenate([z, g.uniform(0.2, 0.8, m).astype(np.float32)])
    n = sxy.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    tris = ClippedTriangles(
        sxy=t(sxy), z=t(np.repeat(z[:, None], 3, 1)),
        inv_w=t(np.ones((n, 3), np.float32)),
        bary=t(np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))),
        tri_id=t(np.arange(n, dtype=np.int32)),
        valid=t(np.ones(n, bool)))
    rec, bbox, valid = raster_cuda.pack_candidates(tris)
    tile_start, entry_cand = raster_cuda.bin_candidates(bbox, valid, width,
                                                        height)
    return rec, tile_start, entry_cand
