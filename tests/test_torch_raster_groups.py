"""K1v's resolve (csrc/raster.cu raster_tiles_kernel, keyed mode)
replayed here in PyTorch: one block per 16x16 tile walks the tile's list
in 128-entry groups, each staged on its own; inside a group each pixel
keeps the largest key (2^-17 depth | position), and across groups, in
list order, a group's winner replaces the running one only with a
strictly larger exact depth, so the earliest group keeps a tie. Held
against the plain version (``raster_vis_plain``, which splits the list
into (tile, group) items and combines them by a scatter-max) bit for
bit, on bins where one tile holds several groups with equal exact depths
across them and 2^-17 near-ties inside them."""
import pytest
import torch

from hybridrenderer_tpu_torch.ops import raster, raster_cuda

from .torch_parity import heavy_tile_bins

TILE, GROUP = raster_cuda.TILE, raster_cuda.GROUP


def replay(rec, tile_start, entry_cand, width, height):
    """The kernel's loop, tile by tile and group by group, with its
    arithmetic (K1's depth at the pixel centre) → VisibilityBuffer."""
    ntx = -(-width // TILE)
    ts = tile_start.tolist()
    lp = torch.arange(TILE * TILE)
    won = torch.full((height, width), -1, dtype=torch.long)
    for tile in range(len(ts) - 1):
        x = (tile % ntx) * TILE + lp % TILE
        y = (tile // ntx) * TILE + lp // TILE
        best_z = torch.zeros(TILE * TILE)
        best = torch.full((TILE * TILE,), -1)
        for base in range(ts[tile], ts[tile + 1], GROUP):
            cand = entry_cand[base:min(ts[tile + 1], base + GROUP)].long()
            e, z = raster_cuda._edges_depth(rec[cand].unsqueeze(1), x, y)
            cover = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (z >= 0) \
                & (z <= 1)
            q = torch.clamp(z * raster_cuda.KEY_SCALE, 0.0,
                            raster_cuda.KEY_SCALE).to(torch.int32).long()
            key = torch.where(cover, (q << 7)
                              | torch.arange(cand.shape[0]).unsqueeze(1), -1)
            kmax, win = key.max(dim=0)
            win_z = z[win, lp]
            better = (kmax >= 0) & (win_z > best_z)
            best_z = torch.where(better, win_z, best_z)
            best = torch.where(better, cand[win], best)
        inside = (x < width) & (y < height)
        won[y[inside], x[inside]] = best[inside]
    hit = won >= 0
    vis, _ = raster_cuda._winner_outputs(rec, None, hit,
                                         torch.where(hit, won, 0), width,
                                         height)
    return vis


def _stress_bins(width, height):
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.scene import scene as scenes

    data = scenes.stress_scene(num_objects=12).build("cpu")
    cam = OrbitCamera(width=width, height=height, distance=25.0, pitch=0.5,
                      yaw=0.8, focal_point=(0, 2, 0)).step().to("cpu")
    vp = cam.proj @ cam.view
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (data.triangles.v0, data.triangles.v1,
                                     data.triangles.v2)], dim=1)
    rec, bbox, valid = raster_cuda.pack_candidates(
        raster.clip_triangles(corners, width, height))
    return (rec, *raster_cuda.bin_candidates(bbox, valid, width, height))


@pytest.mark.parametrize("case", ["heavy_600", "heavy_129", "stress"])
def test_replayed_groups_equal_plain(case):
    """The replay equals raster_vis_plain bit for bit: a 40x24 image
    with one tile of 600 entries (5 groups) or of 129 (a second group of
    one entry), and the stress scene at 61x37, whose lists run past 128
    entries in several tiles."""
    if case == "stress":
        W, H = 61, 37
        rec, ts, ec = _stress_bins(W, H)
    else:
        W, H = 40, 24
        rec, ts, ec = heavy_tile_bins(W, H, int(case.split("_")[1]), seed=2)
    counts = ts[1:] - ts[:-1]
    assert int((counts > GROUP).sum()) >= 1
    k = replay(rec, ts, ec, W, H)
    p = raster_cuda.raster_vis_plain(rec, ts, ec, W, H)
    for f in ("tri_id", "depth", "bary1", "bary2"):
        a, b = getattr(k, f), getattr(p, f)
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32)), f
    assert (p.tri_id >= 0).any()


def test_heavy_tile_ties():
    """The synthetic heavy tile has what the kernel's combine must get
    right: group winners of equal exact depth in different groups (the
    earliest group keeps the pixel), and K1v's winner differs from K1's
    (the 2^-17 key's later entry against K1's exact depth) on some
    pixels."""
    W, H = 40, 24
    rec, ts, ec = heavy_tile_bins(W, H, 600, seed=2)
    counts = ts[1:] - ts[:-1]
    heavy = int(counts.argmax())
    assert int(counts[heavy]) == 600
    k1v = raster_cuda.raster_vis_plain(rec, ts, ec, W, H)
    k1, _ = raster_cuda.raster_tiles_plain(rec, ts, ec, None, W, H)
    assert (k1v.tri_id != k1.tri_id).any()
    # entry e and e + 128 are the same triangle at the same depth: every
    # pixel of the heavy tile goes to the tile's first group
    start = int(ts[heavy])
    first = ec[start:start + GROUP].long()
    ntx = -(-W // 16)
    y0, x0 = 16 * (heavy // ntx), 16 * (heavy % ntx)
    won = k1v.tri_id[y0:y0 + 16, x0:x0 + 16]
    won = won[won >= 0].long()
    assert won.numel() > 100
    assert torch.isin(won, first).all()
