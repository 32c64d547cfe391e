"""The reference's own parts against plain truths: its rasterizer
against the analytic ray-plane intersection (a floor that reaches
behind the camera too), its tree against testing every triangle, its
direction patterns and ray offsets against the port's, which carry the
same meaning; the forward frame against the closed-form sun and sky
light of a plane seen head-on, and a blocker's shadow; TAA's resolve
against what a first frame, an image resolved against itself and an
outlying history must give; and the references load nothing of the
port."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from framebench import scenegen, spec
from framebench.reference import bvh, forward, raster, shading, taa
from framebench.traffic import Traffic, perspective_reversed_z, view_matrix

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
            "import framebench.reference.render, "
            "framebench.reference.hybrid, framebench.reference.forward, "
            "framebench.reference.taa; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hybridrenderer_tpu_torch', 'hybridrenderer_tpu', 'jax'}))"
            % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- the forward frame ----------------------------------------------------

FWD = {"render": {"path": "FORWARD", "width": W, "height": H,
                  "flags": ["LIGHT", "IBL", "EMISSIVE", "SHADOW", "TAA"]}}
FLOOR = dict(colour=(0.6, 0.5, 0.4), roughness=0.5)


def _forward_frame(sun, blocker=False, intensity=3.0):
    """The first forward frame of a 60 x 60 floor (and a 2-unit box
    floating 3 to 5 units above its middle), seen from 20 units straight
    above, unjittered → (image, G-buffer)."""
    meshes, transforms = [scenegen.plane(60.0, 0, 1.0)], [np.eye(4)]
    if blocker:
        t = np.diag([2.0, 2.0, 2.0, 1.0])
        t[1, 3] = 4.0
        meshes.append(scenegen.cube(1))
        transforms.append(t)
    desc = scenegen.SceneDesc(
        materials=[FLOOR, dict(colour=(0.2, 0.2, 0.2))], meshes=meshes,
        transforms=np.stack(transforms).astype(np.float32),
        kinds=["floor", "box"][:len(meshes)], textures=None,
        sun=dict(direction=sun, intensity=intensity))
    traffic = Traffic({"camera": dict(
        distance=20.0, pitch=np.pi / 2, yaw=0.0, focal_point=[0, 0, 0],
        orbit=0.0, taa_jitter=False)}, 1, W, H, desc.kinds,
        desc.transforms)
    ref = forward.Reference(FWD, desc, traffic, torch.device("cpu"))
    out = ref.frame(1)
    g = ref._gbuffer(forward.Camera(*traffic.camera(1), device="cpu"))
    return out["image"], g


def test_forward_lights_a_plane_seen_head_on_as_the_closed_form():
    # sun and eye straight above: n = v = l, so the GGX term is
    # F D G / 4 with F = 0.04, D = 1 / (pi a^2), G = 1, and the sky
    # along the normal and the mirror ray is the zenith's colour
    image, _ = _forward_frame((0.0, -1.0, 0.0))
    albedo = np.array(FLOOR["colour"])
    a = (FLOOR["roughness"] ** 2) ** 2
    direct = (albedo * 0.96 / np.pi + 0.04 / (4.0 * np.pi * a)) * 3.0
    zenith = np.array([0.1, 0.2, 0.4])
    ambient = (0.96 * zenith * albedo + 0.04 * zenith) * 0.05
    want = (direct + ambient) ** (1.0 / 2.2)
    centre = image[H // 2 - 1:H // 2 + 1, W // 2 - 1:W // 2 + 1]
    assert np.allclose(centre.reshape(-1, 3).numpy(), want, rtol=1e-3)


def test_forward_pixel_behind_a_blocker_has_no_direct_term():
    # the sun along (1, 2, 0): the box's shadow falls on the floor over
    # x in [-3.5, -0.5], z in [-1, 1]; where the floor shows there, the
    # pixel is what the floor gives with the sun put out
    sun = (-1.0, -2.0, 0.0)
    shadowed, g = _forward_frame(sun, blocker=True)
    dark, _ = _forward_frame(sun, intensity=0.0)
    lit, _ = _forward_frame(sun)
    pos = g["pos"]
    under = g["fg"] & (pos[..., 0] > -3.3) & (pos[..., 0] < -1.7) \
        & (pos[..., 2].abs() < 0.8) & (pos[..., 1].abs() < 1e-4)
    assert under.sum() >= 4
    assert torch.allclose(shadowed[under], dark[under], atol=1e-6)
    assert (lit[under] > dark[under] + 0.05).all()


def _smooth(seed=0):
    g = torch.Generator().manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                            torch.arange(W, dtype=torch.float32),
                            indexing="ij")
    c = torch.rand(3, generator=g) * 0.02
    return torch.stack([0.3 + c[i] * xs + 0.01 * ys * i for i in range(3)],
                       -1)


def _nearness():
    return torch.linspace(0.1, 0.9, W).expand(H, W).contiguous()


def test_taa_first_frame_is_the_current_image():
    g = torch.Generator().manual_seed(4)
    cur = torch.rand(H, W, 3, generator=g) * 3.0
    motion = (torch.rand(H, W, 2, generator=g) - 0.5) * 0.02
    out = taa.resolve(cur, None, motion, _nearness(), (0.01, -0.02),
                      (0.0, 0.0))
    assert torch.allclose(out, cur, rtol=1e-5, atol=1e-6)


def test_taa_resolves_a_still_image_against_itself_to_itself():
    cur = _smooth()
    zero = torch.zeros(H, W, 2)
    out = taa.resolve(cur, cur.clone(), zero, _nearness(), (0.0, 0.0),
                      (0.0, 0.0))
    assert torch.allclose(out, cur, rtol=1e-5, atol=1e-6)
    # a history of another colour is blended in by 0.9
    other = taa.resolve(cur, cur * 0.99, zero, _nearness(), (0.0, 0.0),
                        (0.0, 0.0))
    assert not torch.allclose(other, cur, rtol=1e-4)


def test_taa_clip_pulls_an_outlying_history_onto_the_box():
    lo = torch.tensor([0.2, -0.1, -0.05])
    hi = torch.tensor([0.4, 0.1, 0.05])
    far = torch.tensor([0.9, 0.3, -0.2])
    got = taa.clip_to_box(far, lo, hi)
    assert ((got >= lo - 1e-6) & (got <= hi + 1e-6)).all()
    on_face = torch.isclose(got, lo, atol=1e-6) | torch.isclose(got, hi,
                                                                atol=1e-6)
    assert on_face.any()
    centre = 0.5 * (lo + hi)
    # on the segment from the history to the box's centre
    s = (got - far) / (centre - far)
    assert torch.allclose(s, s[0].expand(3), atol=1e-5) and 0 < s[0] < 1
    inside = torch.tensor([0.3, 0.02, 0.01])
    assert torch.equal(taa.clip_to_box(inside, lo, hi), inside)
