"""Binned tile rasterizer: host half in PyTorch and kernels K1 and K1v
(hybridrenderer_tpu/ops/raster_pallas.py).

1. ``pack_candidates`` turns each post-clip candidate into a 24-float
   record: its three screen-space edge functions, winding sign, inverse
   area, vertex depths and 1/w, and original-triangle barycentrics.
2. ``bin_candidates`` lists, for every 16x16 pixel tile, every candidate
   whose screen bbox touches it. The lists are exact: no cap, no
   overflow class, no candidate dropped. Their length is data-dependent,
   so a frame captured into a CUDA graph bins into a fixed capacity
   instead (``Binning``): the same lists, padded, and the entries needed
   on the device, which the renderer checks after the replay; a frame
   that needed more raises.
3. ``raster_tiles`` resolves each pixel's winner (largest reversed-Z
   depth; ties to the lowest candidate index) and writes the
   VisibilityBuffer and, unless it runs vis-only, the (H, W, 40)
   interpolated attribute image, f32, or with ``attr_bits=16`` rounded
   to bf16 (K1's bf16 mode; ``rasterize_binned`` hands the G-buffer
   math its f32 upcast, as the reference's rasterize_binned does). CUDA
   tensors run kernel K1 (csrc/raster.cu); CPU tensors run
   ``raster_tiles_plain``, the same arithmetic in PyTorch. With
   ``keyed`` it runs vis-only with the winner rule of the reference's
   eval modes v2 / v3: kernel K1v (K1's keyed mode), plain version
   ``raster_vis_plain``. That rule differs
   from K1's only between candidates within 2^-17 of reversed-Z
   (csrc/raster.cu says how).

The arithmetic is the reference's jnp resolve (ops/raster.py
rasterize), whose goldens the port is held to; csrc/raster.cu says why.

Every step takes a row window (``row0``, ``height`` rows of an image
``full_height`` rows tall; by default the whole image), a row-sharded
frame's shard (parallel/sharded.py): the window's pixels are those of
the 16-row tile bands it touches, binned as on the whole image, so that
each band's list, and with it every winner (K1v's near-ties too), is the
whole image's; pixel centres are ``row0 + y + 0.5``.
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
KERNEL_BF16 = native.KERNELS["raster_tiles_bf16"]


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


def bin_candidates(bbox, valid, width, height, row0=0, full_height=None):
    """Exact per-tile candidate lists → (tile_start (ntiles + 1,) i32,
    entry_cand (E,) i32). Tile t's candidates, in ascending candidate
    order, are entry_cand[tile_start[t]:tile_start[t + 1]]; the tiles
    are those of the bands rows ``row0`` .. ``row0 + height - 1`` touch.
    Reading E syncs with the device."""
    tile_start, entry_cand, _ = _bin(bbox, valid, width, height, None,
                                     row0, full_height)
    return tile_start, entry_cand


def _bin(bbox, valid, width, height, capacity, row0=0, full_height=None):
    """The lists in ``capacity`` entries (None: exactly as many as needed,
    read on the host) → (tile_start, entry_cand, entries needed () i64
    on the device). Entry e (in candidate order) belongs to the candidate
    whose entry range [ends - count, ends) holds e; entries past the
    total take tile ``ntiles`` and sort after every real one. While the
    entries needed fit the capacity, tile_start and
    entry_cand[:tile_start[-1]] equal the exact lists and zeros follow;
    past it the last candidates' entries are dropped, and only
    ``needed > capacity`` tells."""
    dev = bbox.device
    FH = height if full_height is None else full_height
    ntx, nty = _tiles(width, height, row0)
    ntiles = ntx * nty
    onscreen = valid & (bbox[:, 1] >= 0) & (bbox[:, 0] < width) & \
        (bbox[:, 3] >= 0) & (bbox[:, 2] < FH)

    def tile_index(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).long()

    tx0, tx1 = tile_index(bbox[:, 0], ntx), tile_index(bbox[:, 1], ntx)
    # the whole image's bands, then those of the window, from its first
    bands = _tiles(width, FH)[1]
    band0 = row0 // TILE
    ty0 = torch.clamp(tile_index(bbox[:, 2], bands) - band0, min=0)
    ty1 = torch.clamp(tile_index(bbox[:, 3], bands) - band0, max=nty - 1)
    onscreen = onscreen & (ty0 <= ty1)
    span_w = tx1 - tx0 + 1
    count = torch.where(onscreen, span_w * (ty1 - ty0 + 1), 0)
    ends = torch.cumsum(count, 0)
    n_cand = count.shape[0]
    needed = ends[-1] if n_cand else torch.zeros((), dtype=torch.long,
                                                  device=dev)
    n = int(needed) if capacity is None else capacity
    if n_cand == 0:
        return (torch.zeros(ntiles + 1, dtype=torch.int32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev), needed)
    e = torch.arange(n, device=dev)
    cand = torch.searchsorted(ends, e, right=True)
    real = cand < n_cand
    cand = torch.clamp(cand, max=n_cand - 1)
    local = e - (ends - count)[cand]
    sw = span_w[cand]
    tile = (ty0[cand] + torch.div(local, sw, rounding_mode="floor")) * ntx \
        + tx0[cand] + local % sw
    tile, order = torch.sort(torch.where(real, tile, ntiles), stable=True)
    entry_cand = torch.where(tile < ntiles, cand[order], 0).to(torch.int32)
    tile_start = torch.searchsorted(
        tile, torch.arange(ntiles + 1, device=dev)).to(torch.int32)
    return tile_start, entry_cand, needed


class Binning:
    """How a frame's rasters bin: into exact lists (``capacity`` None) or,
    with no host sync, into ``capacity`` entries each (a captured frame);
    ``needed`` collects the entries each raster needed, as device
    values."""

    def __init__(self, capacity=None):
        self.capacity = capacity
        self.needed = []

    def bin(self, bbox, valid, width, height, row0=0, full_height=None):
        tile_start, entry_cand, needed = _bin(bbox, valid, width, height,
                                              self.capacity, row0,
                                              full_height)
        self.needed.append(needed)
        return tile_start, entry_cand

    def max_needed(self, device):
        """The most entries any raster of the frame needed, () i64."""
        if not self.needed:
            return torch.zeros((), dtype=torch.long, device=device)
        return torch.stack(self.needed).max()


def _tiles(width, height, row0=0):
    """Tile columns, and the 16-row bands rows ``row0`` .. ``row0 +
    height - 1`` touch."""
    return -(-width // TILE), (row0 + height - 1) // TILE - row0 // TILE + 1


def raster_tiles(rec, tile_start, entry_cand, attr_table, width, height,
                 keyed=False, attr_bits=32, row0=0):
    """Resolve every pixel → (VisibilityBuffer, attrs (H, W, 40)), or
    (VisibilityBuffer, None) vis-only when ``attr_table`` is None; the
    rows ``row0`` .. ``row0 + height - 1`` of the image, from lists of
    the bands they touch (``bin_candidates``).
    ``keyed`` (vis-only) takes the v2 / v3 winner rule; ``attr_bits``
    16 gives the attributes as bf16, each the f32 value rounded to
    nearest (K1's bf16 mode, counted as ``raster_tiles_bf16``).

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
    if attr_bits not in (16, 32):
        raise ValueError(f"raster_tiles: attr_bits must be 16 or 32, got "
                         f"{attr_bits}")
    bf16 = attr_bits == 16 and attr_table is not None
    if rec.device.type == "cpu":
        if keyed:
            return raster_vis_plain(rec, tile_start, entry_cand, width,
                                    height, row0=row0), None
        if bf16:
            return raster_tiles_bf16_plain(rec, tile_start, entry_cand,
                                           attr_table, width, height,
                                           row0=row0)
        return raster_tiles_plain(rec, tile_start, entry_cand, attr_table,
                                  width, height, row0=row0)
    if rec.device.type != "cuda":
        raise ValueError(f"raster_tiles: unsupported device {rec.device}")
    dev = rec.device
    ntx, nty = _tiles(width, height, row0)
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
        attrs = torch.empty((height, width, ATTR_OUT), device=dev,
                            dtype=torch.bfloat16 if bf16 else torch.float32)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    tri = torch.empty((height, width), dtype=torch.int32, device=dev)
    bary = torch.empty((height, width, 2), dtype=torch.float32, device=dev)
    kernel = KERNEL_VIS if keyed else KERNEL_BF16 if bf16 else KERNEL
    kernel.launch(
        "hr_raster_tiles", native.ptr(rec), native.ptr(tile_start),
        native.ptr(entry_cand),
        None if attrs is None else native.ptr(attr_table), int(keyed),
        int(bf16), width, height, row0, ntx, nty, native.ptr(depth),
        native.ptr(tri),
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
    integer image pixels (x, y)."""
    e = _edges(r, x.to(torch.float32) + 0.5, y.to(torch.float32) + 0.5)
    inv_area = r[..., 10]
    return e, (e[0] * inv_area) * r[..., 11] + (e[1] * inv_area) * r[..., 12] \
        + (e[2] * inv_area) * r[..., 13]


def _entry_pixels(rec, tile_start, entry_cand, width, chunk_entries,
                  row0=0):
    """Every (tile entry, pixel of its tile) pair, ``chunk_entries``
    entries at a time → (first entry, candidates (E,), pixel index into
    the padded bands (E, 256), covered (E, 256), depth (E, 256)) with
    K1's arithmetic; the first band is the one of image row ``row0``."""
    dev = rec.device
    ntx = -(-width // TILE)
    Wp = ntx * TILE
    y0 = row0 // TILE * TILE
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
        e, z = _edges_depth(rec[cand].unsqueeze(1), x, y0 + y)  # (E, 256)
        cover = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (z >= 0) & (z <= 1)
        yield e0, cand, y * Wp + x, cover, z


def _winner_outputs(rec, attr_table, hit, win, width, height, row0=0):
    """The winner's outputs, with the kernels' arithmetic in their
    order: hit, win (H, W) of image rows ``row0`` on → (VisibilityBuffer,
    attrs or None)."""
    dev = rec.device
    px = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5)[None, :]
    py = (torch.arange(row0, row0 + height, device=dev,
                       dtype=torch.float32) + 0.5)[:, None]
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


def _padded_size(width, height, row0=0):
    ntx, nty = _tiles(width, height, row0)
    return nty * TILE * ntx * TILE


def _crop(best, width, height, row0=0):
    """The padded bands → the window's rows."""
    ntx, nty = _tiles(width, height, row0)
    first = row0 % TILE
    return best.view(nty * TILE, ntx * TILE)[first:first + height, :width]


MASK32 = 0xFFFFFFFF


def raster_tiles_plain(rec, tile_start, entry_cand, attr_table, width,
                       height, chunk_entries=4096, row0=0):
    """Plain PyTorch version of kernel K1: every (tile entry, pixel) pair
    evaluated as tensors, the winner picked by a per-pixel scatter-max of
    (depth bits, ~candidate), then the winner's outputs evaluated with
    the kernel's arithmetic in the kernel's order. Padded lists
    (a ``Binning`` capacity) are read up to their last tile's end."""
    KERNEL.note_plain(rec)
    return _raster_f32_plain(rec, tile_start, entry_cand, attr_table, width,
                             height, chunk_entries, row0)


def _raster_f32_plain(rec, tile_start, entry_cand, attr_table, width,
                      height, chunk_entries, row0=0):
    entry_cand = entry_cand[:int(tile_start[-1])]
    best = torch.full((_padded_size(width, height, row0),), -1,
                      dtype=torch.int64, device=rec.device)
    for _, cand, pix, cover, z in _entry_pixels(rec, tile_start, entry_cand,
                                                width, chunk_entries, row0):
        # depth must beat 0, the cleared far plane
        cover = cover & (z > 0)
        key = (z.view(torch.int32).long() << 32) | \
            (MASK32 - cand).unsqueeze(1)
        best.scatter_reduce_(0, pix[cover], key[cover], "amax")
    best = _crop(best, width, height, row0)
    hit = best >= 0
    win = torch.where(hit, MASK32 - (best & MASK32), 0)
    return _winner_outputs(rec, attr_table, hit, win, width, height, row0)


def raster_tiles_bf16_plain(rec, tile_start, entry_cand, attr_table, width,
                            height, chunk_entries=4096, row0=0):
    """Plain PyTorch version of K1's bf16 mode: the f32 raster, its
    attributes rounded to the nearest bf16."""
    KERNEL_BF16.note_plain(rec)
    vis, attrs = _raster_f32_plain(rec, tile_start, entry_cand, attr_table,
                                   width, height, chunk_entries, row0)
    return vis, attrs.to(torch.bfloat16)


def raster_vis_plain(rec, tile_start, entry_cand, width, height,
                     chunk_entries=4096, row0=0):
    """Plain PyTorch version of kernel K1v, in two scatter-max rounds:
    each (group of 128 entries, pixel) keeps its largest integer key;
    then each pixel keeps the group winner of largest exact depth, the
    earliest group on a tie (the kernel's strict replacement in list
    order). Padded lists are read up to their last tile's end."""
    KERNEL_VIS.note_plain(rec)
    entry_cand = entry_cand[:int(tile_start[-1])]
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
                                            width, chunk_entries, row0):
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
    ntx = _tiles(width, height, row0)[0]
    x = (tile_of_group % ntx) * TILE + lp % TILE
    y = torch.div(tile_of_group, ntx, rounding_mode="floor") * TILE \
        + torch.div(lp, TILE, rounding_mode="floor")
    cand = entry_cand[entry].long()
    _, z = _edges_depth(rec[cand], x, row0 // TILE * TILE + y)
    ok = z > 0
    # strictly larger depth replaces: the earliest group wins a tie
    local_group = g - first_group[tile_of_group]
    key = (z.view(torch.int32).long() << 32) | (MASK32 - local_group)
    best = torch.full((_padded_size(width, height, row0),), -1,
                      dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, (y * ntx * TILE + x)[ok], key[ok], "amax")
    # the winning group → its winner's candidate, per pixel
    won = torch.full_like(best, -1)
    pick = ok & (best[y * ntx * TILE + x] == key)
    won[(y * ntx * TILE + x)[pick]] = cand[pick]
    won = _crop(won, width, height, row0)
    hit = won >= 0
    vis, _ = _winner_outputs(rec, None, hit, torch.where(hit, won, 0), width,
                             height, row0)
    return vis


def rasterize_binned(tris, width, height, attr_table, vis_eval=None,
                     binning=None, attr_bits=32, row0=0, full_height=None):
    """pack → bin → raster: ClippedTriangles → (VisibilityBuffer, attrs).
    ``attr_table`` None resolves vis-only (attrs None), through K1v when
    ``vis_eval`` is "v2" or "v3", else through K1. ``binning``, a
    ``Binning``, says how to bin (default: exact lists). With
    ``attr_bits`` 16 the attributes are stored as bf16 and returned
    upcast to f32. The outputs are ``height`` rows from image row
    ``row0`` of an image ``full_height`` rows tall (default: all)."""
    rec, bbox, valid = pack_candidates(tris)
    tile_start, entry_cand = (binning or Binning()).bin(
        bbox, valid, width, height, row0, full_height)
    if attr_table is not None:
        attr_table = attr_table.contiguous()
    vis, attrs = raster_tiles(rec, tile_start, entry_cand, attr_table, width,
                              height, keyed=attr_table is None
                              and vis_eval in ("v2", "v3"),
                              attr_bits=attr_bits, row0=row0)
    return vis, None if attrs is None else attrs.to(torch.float32)
