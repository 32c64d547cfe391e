"""The frozen generator and the traffic: fixed arrays for a fixed
seed, the same work for every seed, and the port's own meshes."""
import hashlib

import numpy as np
import pytest

from framebench import scenegen, traffic

SPONZA = dict(num_objects=1000, spheres=482, textured=True, tex_size=1024)
ORBIT = dict(camera=dict(distance=30.0, pitch=0.5, yaw=0.8,
                         yaw_jitter=3.14159265, focal_point=[0, 2, 0],
                         orbit=0.01))


def test_arrays_of_a_fixed_seed():
    d = scenegen.generate(SPONZA, 12345)
    digest = hashlib.sha256(d.transforms.tobytes()
                            + "".join(d.kinds).encode()).hexdigest()
    assert digest == ("7f0df36afd9f2f18664abedb496c780a"
                      "47a53b938792de485ffa4237a6dacfe6")
    assert d.num_triangles == 284066
    assert d.textures[0].shape == (4, 1024, 1024, 4)
    assert float(d.textures[0].sum()) == 12030564.0


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5, 2 ** 63 + 1])
def test_every_seed_renders_the_same_triangles(seed):
    d = scenegen.generate(SPONZA, seed)
    assert d.num_triangles == 284066 and d.kinds.count("sphere") == 482
    assert scenegen.generate(dict(SPONZA, num_objects=250, spheres=110),
                             seed).num_triangles == 65258


def test_seeds_move_the_objects():
    a, b = (scenegen.generate(SPONZA, s) for s in (1, 2))
    assert np.array_equal(a.transforms[:19], b.transforms[:19])
    assert not np.array_equal(a.transforms[19:], b.transforms[19:])
    c = scenegen.generate(SPONZA, 1)
    assert np.array_equal(a.transforms, c.transforms) and a.kinds == c.kinds


def test_meshes_are_the_ports():
    from hybridrenderer_tpu_torch.scene import geometry

    pairs = [(scenegen.cube(3), geometry.cube(material=3)),
             (scenegen.plane(60.0, 0, 8.0),
              geometry.plane(size=60.0, material=0, uv_scale=8.0)),
             (scenegen.uv_sphere(12, 24, 2),
              geometry.uv_sphere(rings=12, sectors=24, material=2))]
    for ours, port in pairs:
        for f in ("positions", "normals", "tangents", "uvs", "indices"):
            assert np.array_equal(getattr(ours, f), getattr(port, f)), f


def test_camera_matches_the_ports_orbit_camera():
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera

    d = scenegen.generate(dict(SPONZA, num_objects=20, spheres=5,
                               textured=False), 3)
    tr = traffic.Traffic(ORBIT, 3, 320, 200, d.kinds, d.transforms)
    cam = OrbitCamera(width=320, height=200, distance=30.0, pitch=0.5,
                      yaw=tr.yaw0, focal_point=(0, 2.0, 0))
    for k in range(1, 20):
        cs = cam.step(taa_enabled=True)
        view, proj, pview, pproj, jit, pjit = tr.camera(k)
        for a, b in ((view, cs.view), (proj, cs.proj), (pview, cs.prev_view),
                     (pproj, cs.prev_proj), (jit, cs.jitter),
                     (pjit, cs.prev_jitter)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        cam.orbit(0.01, 0.0)


def test_motion_turns_one_entity_of_its_kind():
    d = scenegen.generate(dict(SPONZA, num_objects=50, spheres=20,
                               textured=False), 9)
    params = dict(ORBIT, motion=dict(kind="box", entities=1, rot_y=0.05))
    tr = traffic.Traffic(params, 9, 64, 48, d.kinds, d.transforms)
    (e,) = tr.moved
    assert d.kinds[e] == "box"
    t = tr.transforms(4)[e]
    np.testing.assert_allclose(t, traffic.rot_y(0.2) @ d.transforms[e],
                               atol=1e-6)
    # it travels a circle about the vertical axis, at its own height
    p0, p4 = d.transforms[e][:3, 3], t[:3, 3]
    assert p4[1] == pytest.approx(p0[1])
    assert np.hypot(p4[0], p4[2]) == pytest.approx(np.hypot(p0[0], p0[2]))
    assert traffic.Traffic(params, 9, 64, 48, d.kinds,
                           d.transforms).moved == [e]
