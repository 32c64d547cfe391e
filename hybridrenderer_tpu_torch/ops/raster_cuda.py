"""Binned tile rasterizer: host half in PyTorch and kernels K1 and K1v
(hybridrenderer_tpu/ops/raster_pallas.py).

1. ``pack_candidates`` turns each post-clip candidate into a 24-float
   record: its three screen-space edge functions, winding sign, inverse
   area, vertex depths and 1/w, and original-triangle barycentrics.
2. ``bin_candidates`` lists, for every 16x16 pixel tile, every candidate
   whose screen bbox touches it. The lists are exact: no cap, no
   overflow class, no candidate dropped.
3. ``raster_tiles`` resolves each pixel's winner (largest reversed-Z
   depth; ties to the lowest candidate index) and writes the
   VisibilityBuffer and, unless it runs vis-only, the (H, W, 40)
   interpolated attribute image. CUDA tensors run kernel K1
   (csrc/raster.cu); CPU tensors run ``raster_tiles_plain``, the same
   arithmetic in PyTorch. With ``keyed`` it runs vis-only with the
   winner rule of the reference's eval modes v2 / v3: kernel K1v (K1's
   keyed mode), plain version ``raster_vis_plain``. That rule differs
   from K1's only between candidates within 2^-17 of reversed-Z
   (csrc/raster.cu says how).

The arithmetic is the reference's jnp resolve (ops/raster.py
rasterize), whose goldens the port is held to; csrc/raster.cu says why.
"""
from __future__ import annotations

import torch

from .. import native
from .raster import AREA_EPS, VisibilityBuffer, edge_coeffs

TILE = 16
REC = 24          # floats per candidate record (layout in csrc/raster.cu)
ATTR_OUT = 40     # interpolated attribute channels per pixel
ATTR_ROW = 72     # scene raster_rows width
GROUP = 128       # K1v's candidates per key group
KEY_SCALE = 131071.0   # K1v's 17-bit depth quantization
KERNEL = native.KERNELS["raster_tiles"]
KERNEL_VIS = native.KERNELS["raster_vis"]


def pack_candidates(tris):
    """ClippedTriangles → (records (T2, 24), bbox (T2, 4), valid (T2,)).
    Candidates with no area are not valid. Triangle ids ride the float
    record, exact below 2^24; ``tris`` holds two slots per triangle."""
    if tris.tri_id.shape[0] // 2 >= 1 << 24:
        raise ValueError("pack_candidates: triangle ids must stay below "
                         "2^24 (they ride the float record)")
    p0, p1, p2 = tris.sxy[:, 0], tris.sxy[:, 1], tris.sxy[:, 2]
    a0, b0, g0 = edge_coeffs(p1, p2)
    a1, b1, g1 = edge_coeffs(p2, p0)
    a2, b2, g2 = edge_coeffs(p0, p1)
    area2 = g0 + a0 * p0[:, 0] + b0 * p0[:, 1]
    sgn = torch.where(area2 < 0, -1.0, 1.0)
    area = torch.abs(area2)
    valid = tris.valid & (area > AREA_EPS)
    inv_area = 1.0 / torch.clamp(area, min=AREA_EPS)
    B = tris.bary
    rec = torch.cat([
        torch.stack([a0, b0, g0, a1, b1, g1, a2, b2, g2, sgn, inv_area], -1),
        tris.z, tris.inv_w, B[:, :, 1], B[:, :, 2],
        tris.tri_id.to(torch.float32).unsqueeze(-1)], dim=-1).contiguous()
    xs, ys = tris.sxy[..., 0], tris.sxy[..., 1]
    bbox = torch.stack([xs.amin(1), xs.amax(1), ys.amin(1), ys.amax(1)], -1)
    return rec, bbox, valid


def bin_candidates(bbox, valid, width, height):
    """Exact per-tile candidate lists → (tile_start (ntiles + 1,) i32,
    entry_cand (E,) i32). Tile t's candidates, in ascending candidate
    order, are entry_cand[tile_start[t]:tile_start[t + 1]]."""
    dev = bbox.device
    ntx = -(-width // TILE)
    nty = -(-height // TILE)
    onscreen = valid & (bbox[:, 1] >= 0) & (bbox[:, 0] < width) & \
        (bbox[:, 3] >= 0) & (bbox[:, 2] < height)

    def tile_index(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).long()

    tx0, tx1 = tile_index(bbox[:, 0], ntx), tile_index(bbox[:, 1], ntx)
    ty0, ty1 = tile_index(bbox[:, 2], nty), tile_index(bbox[:, 3], nty)
    span_w = tx1 - tx0 + 1
    count = torch.where(onscreen, span_w * (ty1 - ty0 + 1), 0)
    ends = torch.cumsum(count, 0)
    E = int(ends[-1]) if ends.numel() else 0
    cand = torch.repeat_interleave(
        torch.arange(count.shape[0], device=dev), count, output_size=E)
    local = torch.arange(E, device=dev) - (ends - count)[cand]
    sw = span_w[cand]
    tile = (ty0[cand] + torch.div(local, sw, rounding_mode="floor")) * ntx \
        + tx0[cand] + local % sw
    tile, order = torch.sort(tile, stable=True)
    entry_cand = cand[order].to(torch.int32)
    per_tile = torch.bincount(tile, minlength=ntx * nty)
    tile_start = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                            torch.cumsum(per_tile, 0)]).to(torch.int32)
    return tile_start, entry_cand


def _tiles(width, height):
    return -(-width // TILE), -(-height // TILE)


def raster_tiles(rec, tile_start, entry_cand, attr_table, width, height,
                 keyed=False):
    """Resolve every pixel → (VisibilityBuffer, attrs (H, W, 40)), or
    (VisibilityBuffer, None) vis-only when ``attr_table`` is None.
    ``keyed`` (vis-only) takes the v2 / v3 winner rule.

    CUDA tensors launch kernel K1, which replaces the TPU kernel
    raster_pallas._raster_kernel_t, or with ``keyed`` kernel K1v, which
    replaces raster_pallas._raster_kernel (eval modes v2 / v3); CPU
    tensors take the plain versions. On the card the candidate loop runs
    from shared memory (~20 FLOP per candidate per pixel), and K1's block
    then writes its tile's attributes as contiguous float4s, so K1 is
    bound by its 176 B of output a pixel; see csrc/raster.cu.
    """
    if keyed and attr_table is not None:
        raise ValueError("raster_tiles: the keyed mode is vis-only")
    if rec.device.type == "cpu":
        if keyed:
            return raster_vis_plain(rec, tile_start, entry_cand, width,
                                    height), None
        return raster_tiles_plain(rec, tile_start, entry_cand, attr_table,
                                  width, height)
    if rec.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {rec.device}")
    dev = rec.device
    ntx, nty = _tiles(width, height)
    native.check(rec, "rec", torch.float32, (None, REC), dev)
    native.check(tile_start, "tile_start", torch.int32, (ntx * nty + 1,),
                 dev)
    native.check(entry_cand, "entry_cand", torch.int32, (None,), dev)
    # the kernels read records as float4s
    rec = native.aligned(rec)
    attrs = None
    if attr_table is not None:
        native.check(attr_table, "attr_table", torch.float32,
                     (None, ATTR_ROW), dev)
        # the kernel reads rows as float4s
        attr_table = native.aligned(attr_table)
        attrs = torch.empty((height, width, ATTR_OUT), dtype=torch.float32,
                            device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 2), dtype=torch.float32, device=dev)
    (KERNEL_VIS if keyed else KERNEL).launch(
        "hr_raster_tiles", native.ptr(rec), native.ptr(tile_start),
        native.ptr(entry_cand),
        None if attrs is None else native.ptr(attr_table), int(keyed),
        width, height, ntx, native.ptr(depth), native.ptr(tri),
        native.ptr(bary), None if attrs is None else native.ptr(attrs))
    vis = VisibilityBuffer(tri_id=tri, bary1=bary[..., 0], bary2=bary[..., 1],
                           depth=depth)
    return vis, attrs


def _edges(r, px, py):
    """The three signed edge functions of records ``r`` at (px, py)."""
    sgn = r[..., 9]
    return [sgn * (r[..., k] * px + r[..., k + 1] * py + r[..., k + 2])
            for k in (0, 3, 6)]


def _edges_depth(r, x, y):
    """Edge functions and K1's depth of records ``r`` at the centres of
    integer pixels (x, y)."""
    e = _edges(r, x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5)
    inv_area = r[..., 10]
    return e, (e[0] * inv_area) * r[..., 11] + (e[1] * inv_area) * r[..., 12] \
        + (e[2] * inv_area) * r[..., 13]


def _entry_pixels(rec, tile_start, entry_cand, width, chunk_entries):
    """Every (tile entry, pixel of its tile) pair, ``chunk_entries``
    entries at a time → (first entry, candidates (E,), pixel index into
    the padded image (E, 256), covered (E, 256), depth (E, 256)) with
    K1's arithmetic."""
    dev = rec.device
    ntx = -(-width // TILE)
    Wp = ntx * TILE
    counts = tile_start[1:].long() - tile_start[:-1].long()
    tile_of = torch.repeat_interleave(torch.arange(counts.shape[0],
                                                   device=dev), counts)
    lx = torch.arange(TILE * TILE, device=dev) % TILE
    ly = torch.arange(TILE * TILE, device=dev) // TILE
    for e0 in range(0, entry_cand.shape[0], chunk_entries):
        cand = entry_cand[e0:e0 + chunk_entries].long()
        t = tile_of[e0:e0 + chunk_entries]
        x = (t % ntx).unsqueeze(1) * TILE + lx
        y = torch.div(t, ntx, rounding_mode="floor").unsqueeze(1) * TILE + ly
        e, z = _edges_depth(rec[cand].unsqueeze(1), x, y)   # (E, 256)
        cover = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (z >= 0) & (z <= 1)
        yield e0, cand, y * Wp + x, cover, z


def _winner_outputs(rec, attr_table, hit, win, width, height):
    """The winner's outputs, with the kernels' arithmetic in their
    order: hit, win (H, W) → (VisibilityBuffer, attrs or None)."""
    dev = rec.device
    px = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5)[None, :]
    py = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5)[:, None]
    r = rec[win]                                             # (H, W, 24)
    inv_area = r[..., 10]
    l0, l1, l2 = (e * inv_area for e in _edges(r, px, py))
    z = l0 * r[..., 11] + l1 * r[..., 12] + l2 * r[..., 13]
    u0, u1, u2 = l0 * r[..., 14], l1 * r[..., 15], l2 * r[..., 16]
    s = torch.clamp(u0 + u1 + u2, min=1e-20)
    pc0, pc1, pc2 = u0 / s, u1 / s, u2 / s
    b1 = pc0 * r[..., 17] + pc1 * r[..., 18] + pc2 * r[..., 19]
    b2 = pc0 * r[..., 20] + pc1 * r[..., 21] + pc2 * r[..., 22]
    tri = r[..., 23].to(torch.int32)
    zero = torch.zeros_like(z)
    vis = VisibilityBuffer(tri_id=torch.where(hit, tri, -1),
                           bary1=torch.where(hit, b1, zero),
                           bary2=torch.where(hit, b2, zero),
                           depth=torch.where(hit, z, zero))
    if attr_table is None:
        return vis, None
    row = attr_table[tri.long()]                             # (H, W, 72)
    b0 = 1.0 - b1 - b2
    lerp = row[..., 0:16] * b0.unsqueeze(-1) \
        + row[..., 16:32] * b1.unsqueeze(-1) \
        + row[..., 32:48] * b2.unsqueeze(-1)
    attrs = torch.cat([lerp, row[..., 48:72]], dim=-1)
    attrs = torch.where(hit.unsqueeze(-1), attrs, torch.zeros_like(attrs))
    return vis, attrs


def _padded_size(width, height):
    ntx, nty = _tiles(width, height)
    return nty * TILE * ntx * TILE


def _crop(best, width, height):
    ntx, nty = _tiles(width, height)
    return best.view(nty * TILE, ntx * TILE)[:height, :width]


MASK32 = 0xFFFFFFFF


def raster_tiles_plain(rec, tile_start, entry_cand, attr_table, width,
                       height, chunk_entries=4096):
    """Plain PyTorch version of kernel K1: every (tile entry, pixel) pair
    evaluated as tensors, the winner picked by a per-pixel scatter-max of
    (depth bits, ~candidate), then the winner's outputs evaluated with
    the kernel's arithmetic in the kernel's order."""
    KERNEL.note_plain(rec)
    best = torch.full((_padded_size(width, height),), -1, dtype=torch.int64,
                      device=rec.device)
    for _, cand, pix, cover, z in _entry_pixels(rec, tile_start, entry_cand,
                                                width, chunk_entries):
        # depth must beat 0, the cleared far plane
        cover = cover & (z > 0)
        key = (z.view(torch.int32).long() << 32) | \
            (MASK32 - cand).unsqueeze(1)
        best.scatter_reduce_(0, pix[cover], key[cover], "amax")
    best = _crop(best, width, height)
    hit = best >= 0
    win = torch.where(hit, MASK32 - (best & MASK32), 0)
    return _winner_outputs(rec, attr_table, hit, win, width, height)


def raster_vis_plain(rec, tile_start, entry_cand, width, height,
                     chunk_entries=4096):
    """Plain PyTorch version of kernel K1v, in two scatter-max rounds:
    each (group of 128 entries, pixel) keeps its largest integer key;
    then each pixel keeps the group winner of largest exact depth, the
    earliest group on a tie (the kernel's strict replacement in list
    order)."""
    KERNEL_VIS.note_plain(rec)
    dev = rec.device
    starts = tile_start.long()
    counts = starts[1:] - starts[:-1]
    groups = torch.div(counts + GROUP - 1, GROUP, rounding_mode="floor")
    first_group = torch.cumsum(groups, 0) - groups
    tile_of = torch.repeat_interleave(torch.arange(counts.shape[0],
                                                   device=dev), counts)
    pos = torch.arange(entry_cand.shape[0], device=dev) - starts[tile_of]
    gid = first_group[tile_of] + torch.div(pos, GROUP, rounding_mode="floor")
    n_pix = TILE * TILE
    lpix = torch.arange(n_pix, device=dev)
    group_key = torch.full((int(groups.sum()) * n_pix,), -1,
                           dtype=torch.int64, device=dev)
    for e0, _, _, cover, z in _entry_pixels(rec, tile_start, entry_cand,
                                            width, chunk_entries):
        sl = slice(e0, e0 + cover.shape[0])
        q = torch.clamp(z * KEY_SCALE, 0.0, KEY_SCALE).to(torch.int32).long()
        key = (q << 7) | (pos[sl] % GROUP).unsqueeze(1)
        idx = gid[sl].unsqueeze(1) * n_pix + lpix
        group_key.scatter_reduce_(0, idx[cover], key[cover], "amax")

    # group winners → their exact depth at their pixel
    flat = torch.nonzero(group_key >= 0).squeeze(1)
    g, lp = torch.div(flat, n_pix, rounding_mode="floor"), flat % n_pix
    tile_of_group = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=dev), groups)[g]
    entry = starts[tile_of_group] + (g - first_group[tile_of_group]) * GROUP \
        + (group_key[flat] & (GROUP - 1))
    ntx = _tiles(width, height)[0]
    x = (tile_of_group % ntx) * TILE + lp % TILE
    y = torch.div(tile_of_group, ntx, rounding_mode="floor") * TILE \
        + torch.div(lp, TILE, rounding_mode="floor")
    cand = entry_cand[entry].long()
    _, z = _edges_depth(rec[cand], x, y)
    ok = z > 0
    # strictly larger depth replaces: the earliest group wins a tie
    local_group = g - first_group[tile_of_group]
    key = (z.view(torch.int32).long() << 32) | (MASK32 - local_group)
    best = torch.full((_padded_size(width, height),), -1, dtype=torch.int64,
                      device=dev)
    best.scatter_reduce_(0, (y * ntx * TILE + x)[ok], key[ok], "amax")
    # the winning group → its winner's candidate, per pixel
    won = torch.full_like(best, -1)
    pick = ok & (best[y * ntx * TILE + x] == key)
    won[(y * ntx * TILE + x)[pick]] = cand[pick]
    won = _crop(won, width, height)
    hit = won >= 0
    vis, _ = _winner_outputs(rec, None, hit, torch.where(hit, won, 0), width,
                             height)
    return vis


def rasterize_binned(tris, width, height, attr_table, vis_eval=None):
    """pack → bin → raster: ClippedTriangles → (VisibilityBuffer, attrs).
    ``attr_table`` None resolves vis-only (attrs None), through K1v when
    ``vis_eval`` is "v2" or "v3", else through K1."""
    rec, bbox, valid = pack_candidates(tris)
    tile_start, entry_cand = bin_candidates(bbox, valid, width, height)
    if attr_table is not None:
        attr_table = attr_table.contiguous()
    return raster_tiles(rec, tile_start, entry_cand, attr_table, width,
                        height, keyed=attr_table is None
                        and vis_eval in ("v2", "v3"))
