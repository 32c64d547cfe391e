"""The reading behind the image gates of tests/test_torch_slice.py (the
hybrid frame) and tests/test_torch_full_graph.py (the full graph, with
reflections and diffuse GI): how far the reference disagrees with
itself, and the port with it.

    JAX_PLATFORMS=cpu python -m tests.torch_gate_reading [CASE ...]

For each case (the slice test's scenes and cameras, 64x64, 3 frames,
golden settings) it renders the reference twice — jitted, and eagerly
under ``jax.disable_jit()`` — and the port once, from the same scene
arrays, and prints the off-edge max and p99 (u8) of reference jit vs
eager and of port vs reference jit, for the last frame. The two
reference renders run the same operations; only multiply-add
contraction and fusion under jit separate them. CASE is one of
cube, cornell, cube_no_spatial, cornell_no_spatial, cube_full,
cornell_full (default: all), or cornell_full_128: the full-graph golden's
case (128x128, 2 frames), which also prints each render against
tests/goldens/cornell_full_128.png, or stress_textured_128 or
cutout_hybrid_128: the textured and the cut-out goldens' cases
(tests/test_torch_textured_frames.py; hybrid flags, 128x128, 2 frames),
printed against their goldens too. An eager reference frame of the hybrid
frame takes about a minute on a CPU, of the full graph several.
"""
import os
import sys

import jax
import numpy as np

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_full_graph import FULL_CASES
from .test_torch_textured_frames import GOLDENS
from .test_torch_slice import (CASES, _edge_tri_ids, _settings,
                               reference_renderer)
from .torch_parity import flatten, off_edge_errors

SIZE, FRAMES = 64, 3
GOLDEN_128 = os.path.join(os.path.dirname(__file__), "goldens",
                          "cornell_full_128.png")


def reading(case):
    size, frames, golden = SIZE, FRAMES, None
    if case == "cornell_full_128":
        case, size, frames, golden = "cornell_full", 128, 2, read_png(
            GOLDEN_128)
    base, _, spatial = case.partition("_no_")
    ref_flags, flags = RefFlags.default_hybrid(), RenderFlags.default_hybrid()
    if case in GOLDENS:
        scene_fn, _, cam_kw, gate_off, gate_p99 = GOLDENS[case]
        size, frames = 128, 2
        golden = read_png(os.path.join(os.path.dirname(__file__), "goldens",
                                       case + ".png"))
    elif base.endswith("_full"):
        base = base[:-len("_full")]
        scene_fn, cam_kw, gate_off, gate_p99 = FULL_CASES[base]
        ref_flags |= RefFlags.REFLECTION | RefFlags.GI
        flags |= RenderFlags.REFLECTION | RenderFlags.GI
    else:
        scene_fn, cam_kw, gate_off, gate_p99 = CASES[base]
    if spatial:
        ref_flags &= ~RefFlags.SVGF_SPATIAL
        flags &= ~RenderFlags.SVGF_SPATIAL
    ref_data = scene_fn().build()
    jit = reference_renderer(ref_data, size, ref_flags)
    eager = reference_renderer(ref_data, size, ref_flags)
    port = Renderer.for_scene(_settings(size).replace(flags=flags),
                              scene_from_numpy(flatten(ref_data), "cpu"))
    cams = [RefCamera(width=size, height=size, **cam_kw) for _ in range(2)]
    cam = OrbitCamera(width=size, height=size, **cam_kw)
    for _ in range(frames):
        state = cams[0].step()
        a = to_u8(np.asarray(jit.render(state)))
        with jax.disable_jit():
            b = to_u8(np.asarray(eager.render(cams[1].step())))
        p = to_u8(port.render_np(cam.step()))
    tri = _edge_tri_ids(ref_data, state, size)
    self_off, self_p99 = off_edge_errors(b, a, tri)
    port_off, port_p99 = off_edge_errors(p, a, tri)
    gate = f"gate {gate_off} / {gate_p99:g}" if not spatial else "no gate"
    print(f"{case} {size}x{size}: reference jit vs eager {self_off} / "
          f"{self_p99:g}; port vs reference {port_off} / {port_p99:g} "
          f"(off-edge max u8 / p99; {gate})", flush=True)
    if golden is not None:
        print("  against the golden: " + "; ".join(
            f"{name} {'%d / %g' % off_edge_errors(img, golden, tri)}"
            for name, img in (("reference jit", a), ("reference eager", b),
                              ("port", p))), flush=True)


def main(argv):
    for case in argv or ("cube", "cornell", "cube_no_spatial",
                         "cornell_no_spatial", "cube_full", "cornell_full"):
        reading(case)


if __name__ == "__main__":
    main(sys.argv[1:])
