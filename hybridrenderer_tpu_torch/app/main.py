"""CLI sandbox (hybridrenderer_tpu/app/main.py): the headless analog of
the Sandbox/EditorLayer app.

Renders a canned or imported scene through any render path, with display
modes and feature flags, to a PNG per frame or an orbit turntable, and
exports the render graph as Mermaid. Frames render on the card (through
the renderer's captured CUDA graphs) unless ``--device cpu`` is given;
``--device cuda`` without a CUDA device is an error, never a silent
switch to the CPU.

Usage:
  python -m hybridrenderer_tpu_torch.app.main --scene cube --size 256 \\
      --path forward --out /tmp/frame.png
  python -m hybridrenderer_tpu_torch.app.main --scene cornell --path hybrid \\
      --frames 8 --orbit 0.1 --out /tmp/seq.png     # seq_000.png ...
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..core.camera import OrbitCamera
from ..core.config import RenderSettings
from ..core.types import DisplayMode, RenderFlags, RenderPathType
from ..runtime.output import write_png
from ..runtime.renderer import Renderer
from ..scene import scene as scenes


def build_scene(name: str, path: str = None):
    if name == "cube":
        return scenes.cube_scene()
    if name == "cornell":
        return scenes.cornell_scene()
    if name == "stress":
        return scenes.stress_scene()
    if name == "cutout":
        return scenes.cutout_scene()
    if name == "file":
        from ..scene.loader import load_scene_file

        return load_scene_file(path)
    raise SystemExit(f"unknown scene '{name}'")


PATHS = {"forward": RenderPathType.FORWARD, "hybrid": RenderPathType.HYBRID,
         "raytraced": RenderPathType.RAYTRACED}


def parse_flags(spec, path) -> "RenderFlags":
    """Comma-separated flag names → RenderFlags; None → per-path default.
    ``path`` may be the CLI string or a RenderPathType."""
    if spec is not None:
        flags = RenderFlags.NONE
        for name in spec.split(","):
            if name:
                flags |= RenderFlags[name.strip().upper()]
        return flags
    if path in ("hybrid", RenderPathType.HYBRID):
        return RenderFlags.default_hybrid()
    return (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.TAA
            | RenderFlags.EMISSIVE)


def default_camera(scene_name: str, width: int, height: int) -> OrbitCamera:
    presets = {
        "cube": dict(distance=7.0, pitch=0.45, yaw=0.6,
                     focal_point=(0, 0.7, 0)),
        "cornell": dict(distance=13.0, pitch=0.0, yaw=0.0,
                        focal_point=(0, 2.5, 0)),
        "stress": dict(distance=30.0, pitch=0.5, yaw=0.8,
                       focal_point=(0, 2.0, 0)),
    }
    kw = presets.get(scene_name, dict(distance=8.0, pitch=0.4))
    return OrbitCamera(width=width, height=height, **kw)


def device_arg(name: str) -> str:
    """``--device``'s value, checked: "cuda" needs a CUDA device."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to render on the CPU)")
    return name


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="hybridrenderer_tpu_torch sandbox")
    ap.add_argument("--scene", default="cube",
                    choices=["cube", "cornell", "stress", "cutout", "file"])
    ap.add_argument("--file", default=None,
                    help="OBJ/GLTF path for --scene file")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--path", default="forward", choices=list(PATHS))
    ap.add_argument("--display", default="final",
                    choices=[m.name.lower() for m in DisplayMode])
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--orbit", type=float, default=0.0,
                    help="yaw radians per frame")
    ap.add_argument("--out", default="frame.png")
    ap.add_argument("--flags", default=None,
                    help="comma list, e.g. light,shadow,ao,svgf,taa,ibl")
    ap.add_argument("--exposure", type=float, default=1.0)
    ap.add_argument("--mermaid", action="store_true",
                    help="print render graph as Mermaid and exit")
    ap.add_argument("--stats", action="store_true",
                    help="print drawn/culled instance counts per frame "
                         "(FrameStats analog)")
    ap.add_argument("--switch-path", default=None, metavar="FRAME:PATH",
                    help="switch render path mid-sequence, e.g. 4:hybrid "
                         "(EditorLayer live path switching analog)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to render (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = device_arg(args.device)
    width = args.width or args.size
    height = args.height or args.size

    flags = parse_flags(args.flags, args.path)

    settings = RenderSettings(
        width=width, height=height, path=PATHS[args.path], flags=flags,
        display_mode=DisplayMode[args.display.upper()])

    host_scene = build_scene(args.scene, args.file)
    data = host_scene.build(device)
    renderer = Renderer.for_scene(settings, data)

    if args.mermaid:
        print(renderer.path.export_mermaid())
        return 0

    cam = default_camera(args.scene, width, height)
    taa_on = bool(flags & RenderFlags.TAA)

    switch_at, switch_to = -1, None
    if args.switch_path:
        f, p = args.switch_path.split(":")
        switch_at, switch_to = int(f), PATHS[p]

    t0 = time.perf_counter()
    for i in range(args.frames):
        if i == switch_at:
            renderer.switch_path(switch_to)
        if args.orbit:
            cam.orbit(args.orbit, 0.0)
        img = renderer.render_np(cam.step(taa_enabled=taa_on),
                                 exposure=args.exposure)
        if args.stats:
            print(f"frame {i}: {renderer.frame_stats()}")
        if args.frames > 1:
            stem = args.out.rsplit(".", 1)[0]
            out_path = f"{stem}_{i:03d}.png"
        else:
            out_path = args.out
        write_png(out_path, img)
    dt = time.perf_counter() - t0
    print(f"rendered {args.frames} frame(s) {width}x{height} "
          f"[{args.path}/{args.display}] on {device} in {dt:.2f}s "
          f"({args.frames / dt:.2f} fps incl. first-use capture) "
          f"-> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
