"""The reading behind the cube image gates of tests/test_torch_slice.py:
how far the reference disagrees with itself, and the port with it.

    JAX_PLATFORMS=cpu python -m tests.torch_gate_reading [CASE ...]

For each case (the slice test's scenes and cameras, 64x64, 3 frames,
golden settings) it renders the reference twice — jitted, and eagerly
under ``jax.disable_jit()`` — and the port once, from the same scene
arrays, and prints the off-edge max and p99 (u8) of reference jit vs
eager and of port vs reference jit, for the last frame. The two
reference renders run the same operations; only multiply-add
contraction and fusion under jit separate them. CASE is one of
cube, cornell, cube_no_spatial, cornell_no_spatial (default: all).
An eager reference frame takes about a minute on a CPU.
"""
import sys

import jax
import numpy as np

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.types import RenderFlags
from hybridrenderer_tpu_torch.runtime.output import to_u8
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .test_torch_slice import (CASES, _edge_tri_ids, _settings,
                               reference_renderer)
from .torch_parity import flatten, off_edge_errors

SIZE, FRAMES = 64, 3


def reading(case):
    base, _, spatial = case.partition("_no_")
    scene_fn, cam_kw, gate_off, gate_p99 = CASES[base]
    ref_flags, flags = RefFlags.default_hybrid(), RenderFlags.default_hybrid()
    if spatial:
        ref_flags &= ~RefFlags.SVGF_SPATIAL
        flags &= ~RenderFlags.SVGF_SPATIAL
    ref_data = scene_fn().build()
    jit = reference_renderer(ref_data, SIZE, ref_flags)
    eager = reference_renderer(ref_data, SIZE, ref_flags)
    port = Renderer.for_scene(_settings(SIZE).replace(flags=flags),
                              scene_from_numpy(flatten(ref_data)))
    cams = [RefCamera(width=SIZE, height=SIZE, **cam_kw) for _ in range(2)]
    cam = OrbitCamera(width=SIZE, height=SIZE, **cam_kw)
    for _ in range(FRAMES):
        state = cams[0].step()
        a = to_u8(np.asarray(jit.render(state)))
        with jax.disable_jit():
            b = to_u8(np.asarray(eager.render(cams[1].step())))
        p = to_u8(port.render_np(cam.step()))
    tri = _edge_tri_ids(ref_data, state, SIZE)
    self_off, self_p99 = off_edge_errors(b, a, tri)
    port_off, port_p99 = off_edge_errors(p, a, tri)
    gate = f"gate {gate_off} / {gate_p99:g}" if not spatial else "no gate"
    print(f"{case}: reference jit vs eager {self_off} / {self_p99:g}; "
          f"port vs reference {port_off} / {port_p99:g} (off-edge max u8 / "
          f"p99; {gate})", flush=True)


def main(argv):
    for case in argv or ("cube", "cornell", "cube_no_spatial",
                         "cornell_no_spatial"):
        reading(case)


if __name__ == "__main__":
    main(sys.argv[1:])
