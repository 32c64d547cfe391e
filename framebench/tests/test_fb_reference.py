"""The reference's own parts against plain truths: its rasterizer
against the analytic ray-plane intersection (a floor that reaches
behind the camera too), its tree against testing every triangle, its
direction patterns and ray offsets against the port's, which carry the
same meaning; and the reference loads nothing of the port."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from framebench import spec
from framebench.reference import bvh, raster, shading
from framebench.traffic import perspective_reversed_z, view_matrix

W, H = 64, 40


def _floor_view(distance):
    view = view_matrix((0.0, 2.0, 0.0), distance, 0.5, 0.8)
    proj = perspective_reversed_z(45.0, W / H, 0.1, 1000.0)
    return view.astype(np.float64), proj.astype(np.float64)


@pytest.mark.parametrize("distance", [30.0, 60.0])
def test_raster_puts_the_floor_where_the_rays_meet_it(distance):
    view, proj = _floor_view(distance)
    s = 30.0
    corners = np.array([(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)])
    tris = torch.tensor([[0, 2, 1], [0, 3, 2]])
    vp = proj @ view
    clip = torch.from_numpy(np.c_[corners, np.ones(4)] @ vp.T).float()
    tri, lam, _ = raster.rasterize(clip, tris, W, H, 0.1,
                                   torch.ones(2, dtype=torch.bool))
    mu = lam / lam.sum(-1, keepdim=True)
    pos = (mu.unsqueeze(-1) * torch.from_numpy(corners)[tris[tri.clamp(
        min=0)]]).sum(-2)
    inv = np.linalg.inv(vp)
    ys, xs = np.mgrid[0:H, 0:W]
    u, v = (xs + 0.5) / W * 2 - 1, (ys + 0.5) / H * 2 - 1

    def unproject(z):
        p = np.stack([u, v, np.full_like(u, z), np.ones_like(u)], -1) @ inv.T
        return p[..., :3] / p[..., 3:]

    a, b = unproject(1.0), unproject(0.0)
    t = a[..., 1] / (a[..., 1] - b[..., 1])
    hit = a + (b - a) * t[..., None]
    on_floor = (t > 0) & (np.abs(hit[..., 0]) < s - 0.5) \
        & (np.abs(hit[..., 2]) < s - 0.5)
    covered = (tri >= 0).numpy()
    assert on_floor.any() and (covered[on_floor]).all()
    err = np.abs(pos.numpy() - hit)[on_floor].max()
    assert err < 1e-4 * distance


def test_raster_culls_back_faces_and_keeps_the_nearest():
    view, proj = _floor_view(20.0)
    vp = proj @ view
    quad = np.array([(-1, 3, 0), (1, 3, 0), (1, 5, 0), (-1, 5, 0)], float)
    near = quad + (0, 0, 2.0)
    pts = np.r_[quad, near]
    clip = torch.from_numpy(np.c_[pts, np.ones(8)] @ vp.T).float()
    both = torch.tensor([[0, 1, 2], [0, 2, 1], [4, 5, 6], [4, 6, 5]])
    tri, _, _ = raster.rasterize(clip, both, W, H, 0.1,
                                 torch.ones(4, dtype=torch.bool))
    shown = set(tri[tri >= 0].tolist())
    # one winding of each pair faces the camera; the nearer pair wins
    # where the two overlap
    assert len(shown & {0, 1}) <= 1 and len(shown & {2, 3}) == 1


def _brute(o, d, v0, v1, v2, tmin, tmax, any_hit):
    t, u, v, hit = bvh._hits(o[:, None], d[:, None], v0[None], (v1 - v0)[None],
                             (v2 - v0)[None], tmin, tmax[:, None])
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    best, k = t.min(1)
    return torch.where(hit.any(1), k, -1), best


@pytest.mark.parametrize("any_hit", [False, True])
def test_tree_finds_what_testing_every_triangle_finds(any_hit):
    g = torch.Generator().manual_seed(5)
    T, R = 700, 3000
    c = torch.rand(T, 3, generator=g) * 20 - 10
    v0 = c + torch.randn(T, 3, generator=g) * 0.6
    v1 = c + torch.randn(T, 3, generator=g) * 0.6
    v2 = c + torch.randn(T, 3, generator=g) * 0.6
    o = torch.rand(R, 3, generator=g) * 24 - 12
    d = torch.nn.functional.normalize(torch.randn(R, 3, generator=g), dim=-1)
    tmax = torch.full((R,), 30.0)
    active = torch.rand(R, generator=g) > 0.1
    t, tri, _, _ = bvh.Tree(v0, v1, v2).query(o, d, 0.01, tmax, active,
                                              any_hit)
    want, want_t = _brute(o, d, v0, v1, v2, 0.01, tmax, any_hit)
    want = torch.where(active, want, -1)
    assert ((tri >= 0) == (want >= 0)).all()
    if not any_hit:
        got = tri >= 0
        assert torch.allclose(t[got], want_t[got], rtol=1e-6)


def test_directions_and_offsets_mean_what_the_ports_do():
    from hybridrenderer_tpu_torch.ops import sampling

    g = torch.Generator().manual_seed(3)
    n = torch.nn.functional.normalize(torch.randn(40, 56, 3, generator=g),
                                      dim=-1)
    for fi, block, salt in ((0, 8, shading.AO_SALT), (7, 4, shading.GI_SALT),
                            (2 ** 20 + 3, 16, shading.AO_SALT)):
        ours = shading.pattern_directions(fi, n, block, salt)
        port = sampling.interleaved_cos_hemisphere(fi, n, block=block,
                                                   salt=salt)
        assert torch.allclose(ours, port, atol=1e-6)
    p = torch.randn(40, 56, 3, generator=g) * 10
    p[0, :4] = torch.tensor([0.01, -0.02, 0.0])
    assert torch.equal(shading.offset_origin(p, n), sampling.offset_ray(p, n))


def test_the_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import framebench.reference.render; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hybridrenderer_tpu_torch', 'hybridrenderer_tpu', 'jax'}))"
            % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
