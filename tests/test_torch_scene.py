"""Port vs reference: scene building, the scene carry-over, the native
BVH, the settings, and the port's independence from JAX."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import bvh as ref_bvh
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.ops import bvh as port_bvh
from hybridrenderer_tpu_torch.scene import scene as port_scenes
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = {
    "cube": (ref_scenes.cube_scene, port_scenes.cube_scene),
    "cornell": (ref_scenes.cornell_scene, port_scenes.cornell_scene),
    "stress4": (lambda: ref_scenes.stress_scene(num_objects=4),
                lambda: port_scenes.stress_scene(num_objects=4)),
}
# joins computed with einsum: XLA and PyTorch may round them apart
DERIVED = ("attr_rows", "raster_rows")


def _fields(obj, prefix=""):
    """(name, numpy array) of every tensor leaf of a port dataclass."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _fields(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v.numpy()


def _lookup(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_from_numpy_round_trip(name):
    ref_data = SCENES[name][0]().build()
    tree = flatten(ref_data)
    data = scene_from_numpy(tree, "cpu")
    names = [n for n, _ in _fields(data)]
    assert "triangles.v0" in names and "raster_rows" in names
    for n, arr in _fields(data):
        np.testing.assert_array_equal(arr, _lookup(tree, n), err_msg=n)
    assert data.sky_texture == int(tree["sky_texture"])
    assert data.device == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_port_built_scene_equals_reference(name):
    tree = flatten(SCENES[name][0]().build())
    data = SCENES[name][1]().build("cpu")
    for n, arr in _fields(data):
        ref_arr = _lookup(tree, n)
        assert arr.dtype == ref_arr.dtype, n
        if n in DERIVED:
            np.testing.assert_allclose(arr, ref_arr, rtol=1e-6, atol=1e-6,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(arr, ref_arr, err_msg=n)


@pytest.mark.parametrize("name", ["cube", "stress4"])
def test_bvh_identical_to_reference(name):
    """The port compiles the same native/bvh_builder.cpp into its own
    build directory; the binned-SAH tree is array-identical."""
    ref_data = SCENES[name][0]().build()
    soup = ref_data.triangles
    ref_tree = ref_bvh.build_bvh_host(soup.v0, soup.v1, soup.v2, "sah")
    v = [torch.from_numpy(np.array(x)) for x in (soup.v0, soup.v1, soup.v2)]
    tree = port_bvh.build_sah(*v)
    assert tree.num_tris == soup.count
    for f in ("node_min", "node_max", "left", "right", "tri"):
        np.testing.assert_array_equal(getattr(tree, f).numpy(),
                                      np.asarray(getattr(ref_tree, f)),
                                      err_msg=f)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hybridrenderer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'hybridrenderer_tpu.')))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_settings_keep_reference_defaults_and_reject_unported():
    s = RenderSettings()
    assert (s.ao_block, s.svgf_bits, s.svgf_atrous_iterations,
            s.ao_interleaved, s.raster_cull, s.raster_attr_bits) == \
        (128, 16, 3, True, "back", 32)
    # the reference's backend fields are not settings of the port, but
    # for trace_backend and raster_eval, which pick between its kernels
    for kw in (dict(raster_backend="pallas"), dict(svgf_backend="pallas"),
               dict(svgf_temporal_gather="tile"), dict(bvh_builder="lbvh")):
        with pytest.raises(TypeError):
            RenderSettings(**kw)
    assert (s.trace_backend, s.raster_eval) == ("auto", None)
    for backend in ("auto", "pallas-wide", "jnp", "pallas"):
        assert RenderSettings(trace_backend=backend).trace_backend == backend
    for kw in (dict(raster_attr_bits=16), dict(trace_backend="wide"),
               dict(raster_eval="v5")):
        with pytest.raises(ValueError):
            RenderSettings(**kw)


def test_entry_points_ask_for_the_card(monkeypatch):
    """Scenes are built on CUDA unless the caller asks for the CPU; with
    no CUDA device that default raises instead of falling back."""
    import inspect

    for fn in (port_scenes.Scene.build, scene_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_scenes.cube_scene().build()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scene_from_numpy(flatten(ref_scenes.cube_scene().build()))
    assert port_scenes.cube_scene().build("cpu").device == torch.device("cpu")


def test_full_graph_settings_keep_reference_defaults():
    s = RenderSettings()
    assert (s.gi_interleaved, s.gi_block, s.reflection_roughness_cutoff,
            s.reflection_half_res, s.gi_half_res) == (True, 64, 0.6, False,
                                                     False)
    # packet relayouts, an A/B switch and a diagnostic cut of the
    # reference are not settings of the port
    for kw in (dict(gi_layout="pattern"), dict(ao_layout="tile"),
               dict(shade_fetch="attr"), dict(debug_radiance_stage="noocc")):
        with pytest.raises(TypeError):
            RenderSettings(**kw)
