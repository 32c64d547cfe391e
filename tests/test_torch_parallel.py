"""The port's row-sharded frame (hybridrenderer_tpu_torch/parallel/) on
the CPU, mirroring tests/test_parallel.py: the mesh, and the frame of
8 shards (each on "cpu") against the port's single-device frame at the
reference's tolerances there (2e-5 on the forward path and for the
fused shadow + AO query against the unfused, 2e-4 with ray passes),
every path and both frames where two are rendered; and the shards'
lockstep. Reading on every comparison with the port's frame: 0 (bit
for bit).
tests/test_torch_parallel_windows.py holds 15-row shards and the
reference."""
import numpy as np
import pytest
import torch

from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.parallel.mesh import (make_mesh, replicated,
                                                    row_sharding)
from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as scenes

from .test_torch_slice import CUBE_CAM
from .torch_parity import clear_reference_knobs, one_torch_thread

FLAGS = RenderFlags.LIGHT | RenderFlags.IBL
FULL = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE \
    | RenderFlags.REFLECTION | RenderFlags.GI
RT = RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE \
    | RenderFlags.TAA
CORNELL_CAM = dict(distance=7.0, pitch=0.3)


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


@pytest.fixture(scope="module")
def cube():
    return scenes.cube_scene().build("cpu")


@pytest.fixture(scope="module")
def cornell():
    return scenes.cornell_scene().build("cpu")


def _pair(settings, data, n=8, frames=1, cam_kw=CUBE_CAM, **kw):
    """(single-device frames, sharded frames) of the same cameras."""
    single = Renderer.for_scene(settings, data)
    sharded = ShardedRenderer.for_scene(
        settings, data, make_mesh(devices=["cpu"] * n), **kw)
    out = []
    for r in (single, sharded):
        cam = OrbitCamera(width=settings.width, height=settings.height,
                          **cam_kw)
        out.append([r.render_np(cam.step(True)) for _ in range(frames)])
    assert sharded.frame_stats() == single.frame_stats()
    return out


def test_mesh_and_sharding():
    """8 shards on the CPU; each shard's rows; a tensor replicated once
    per distinct device; a mesh never quietly uses fewer cards than
    asked for, or the CPU."""
    mesh = make_mesh(devices=["cpu"] * 8)
    assert len(mesh) == 8 and mesh.distinct == (torch.device("cpu"),)
    assert row_sharding(mesh, 64) == tuple((8 * i, 8) for i in range(8))
    x = torch.zeros(64, 32)
    copies = replicated(mesh, x)
    assert len(copies) == 8 and all(c is x for c in copies)
    with pytest.raises(ValueError, match="divisible"):
        row_sharding(mesh, 60)
    count = torch.cuda.device_count()
    with pytest.raises((ValueError, RuntimeError)):
        make_mesh(count + 1)
    with pytest.raises(ValueError):
        make_mesh(devices=[f"cuda:{count}"])
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)


def test_height_not_divisible_raises(cube):
    s = RenderSettings(width=64, height=60, path=RenderPathType.FORWARD,
                       flags=FLAGS)
    with pytest.raises(ValueError, match="divisible"):
        ShardedRenderer(s, cube, make_mesh(devices=["cpu"] * 8))


@pytest.mark.parametrize("flags,frames", [(FLAGS, 1),
                                          (FLAGS | RenderFlags.TAA, 2)])
def test_sharded_forward_matches_single_device(cube, flags, frames):
    """The forward path, and forward + TAA over 2 frames (the second
    reads the gathered history through K5 and a 1-row halo)."""
    s = RenderSettings(width=64, height=64, path=RenderPathType.FORWARD,
                       flags=flags)
    single, sharded = _pair(s, cube, frames=frames)
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-5)


def test_sharded_hybrid_matches_single_device(cube):
    """The hybrid path (shadow + AO + SVGF) over 2 frames: the second
    reprojects the gathered history (K3) and filters with halo rows."""
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=RenderFlags.default_hybrid())
    single, sharded = _pair(s, cube, frames=2)
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4)


def test_sharded_full_graph_matches_single_device(cornell):
    """The cornell full graph (reflection + GI, radiance hits with NEE
    over the emissive light): the NEE seeds of each shard's rays are
    their image pixels'."""
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=FULL)
    single, sharded = _pair(s, cornell, cam_kw=CORNELL_CAM)
    np.testing.assert_allclose(sharded[0], single[0], rtol=0, atol=2e-4)


def test_sharded_raytraced_matches_single_device(cube):
    """The ray-traced path over 2 frames: K1's vis-only depth prepass on
    each shard's rows, primary rays, TAA."""
    s = RenderSettings(width=64, height=64, path=RenderPathType.RAYTRACED,
                       flags=RT)
    single, sharded = _pair(s, cube, frames=2)
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-4)


def test_sharded_fused_shadow_ao_matches_unfused(cornell):
    """The cornell full graph with shadow and AO on 8 shards, with the
    shadow and AO queries fused into one pair query and unfused: the
    same pixels."""
    s = RenderSettings(width=64, height=64, path=RenderPathType.HYBRID,
                       flags=FULL | RenderFlags.SHADOW | RenderFlags.AO)
    mesh = make_mesh(devices=["cpu"] * 8)
    out = []
    for fuse in (False, True):
        r = ShardedRenderer.for_scene(s.replace(fuse_shadow_ao=fuse),
                                      cornell, mesh)
        cam = OrbitCamera(width=64, height=64, **CORNELL_CAM)
        out.append(r.render_np(cam.step(True)))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=2e-5)


def _run_shards(fns, timeout=60.0):
    """_Lockstep.run over ``fns`` in a thread joined with a timeout →
    (results, the exception it raised or None)."""
    import threading

    from hybridrenderer_tpu_torch.parallel.sharded import _Lockstep

    step, box = _Lockstep(len(fns)), {}

    def main():
        try:
            box["out"] = step.run([lambda f=f: f(step) for f in fns],
                                  [torch.device("cpu")] * len(fns))
        except Exception as e:          # the test reads it
            box["err"] = e

    t = threading.Thread(target=main, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), "the shards hung"
    return box.get("out"), box.get("err")


def test_lockstep_exchanges_under_contention():
    """16 shard threads (more than this machine's cores) exchange 150
    times with the interpreter switching threads every microsecond:
    every shard reads every shard's value of every exchange, and one
    shard runs at a time."""
    import sys

    from hybridrenderer_tpu_torch.parallel.sharded import RowExchange

    n, phases, running = 16, 150, []

    def shard(rank, step):
        ex = RowExchange(step, rank, torch.device("cpu"))
        for p in range(phases):
            running.append(rank)
            assert len(running) == 1
            running.pop()
            assert ex._all((rank, p)) == [(j, p) for j in range(n)]
        return rank

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out, err = _run_shards([lambda s, r=r: shard(r, s)
                                for r in range(n)])
    finally:
        sys.setswitchinterval(old)
    assert err is None and out == list(range(n))


def test_lockstep_failure_and_divergence_raise():
    """A shard that raises stops every shard and its error reaches the
    caller; a shard that skips an exchange the others make is reported,
    not waited for."""
    from hybridrenderer_tpu_torch.parallel.sharded import RowExchange

    def shard(rank, step, fail):
        ex = RowExchange(step, rank, torch.device("cpu"))
        for p in range(10):
            if fail(rank, p):
                raise KeyError(f"shard {rank}")
            ex._all(p)

    _, err = _run_shards([lambda s, r=r: shard(r, s, lambda k, p: (k, p) ==
                                                (2, 5)) for r in range(4)])
    assert isinstance(err, KeyError)

    def short(rank, step):
        ex = RowExchange(step, rank, torch.device("cpu"))
        for p in range(3 if rank == 1 else 4):
            ex._all(p)

    _, err = _run_shards([lambda s, r=r: short(r, s) for r in range(4)])
    assert isinstance(err, RuntimeError) and "diverged" in str(err)
