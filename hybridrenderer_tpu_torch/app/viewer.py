"""Interactive live viewer (hybridrenderer_tpu/app/viewer.py) — the
Window / Input / ImGuiLayer analog.

The reference opens a GLFW window with ImGui panels and mouse-driven
camera controls (Sandbox/src/editor/EditorLayer.cpp:182-540,
Chimera/src/core/Window.cpp, Input.cpp). This renderer is headless, so
the interactive shell is an HTTP live view: a dependency-free page shows
the rendered frame and posts orbit / zoom / pan / fly input, render-path
and display-mode switches, and feature-flag toggles back to the renderer
— the same live controls the EditorLayer exposes, over a socket instead
of a swapchain. Frames render on the card through the renderer's
captured CUDA graphs unless ``--device cpu`` is given.

Run:  python -m hybridrenderer_tpu_torch.app.viewer --scene cornell --size 256
then open the printed URL. Endpoints (all JSON unless noted):

  GET  /            the viewer page (HTML+JS, no external assets)
  GET  /frame.png   render one frame with the current camera (PNG)
  GET  /state       settings, camera, frame stats, timing
  POST /input       {"orbit":[dyaw,dpitch]} | {"zoom":d} | {"pan":[dx,dy]}
                    | {"fly":[fwd,strafe,lift]} | {"path":"hybrid"}
                    | {"display":"normal"} | {"toggle":"SHADOW"}
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..core.types import DisplayMode, RenderFlags, RenderPathType
from ..runtime.log import core as _log
from ..runtime.output import encode_png

_PATHS = {"forward": RenderPathType.FORWARD,
          "hybrid": RenderPathType.HYBRID,
          "raytraced": RenderPathType.RAYTRACED}
_TOGGLABLE = ["LIGHT", "SHADOW", "AO", "REFLECTION", "GI", "TAA",
              "SVGF", "SVGF_TEMPORAL", "SVGF_SPATIAL", "IBL", "EMISSIVE"]

_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>HybridRenderer viewer</title><style>
body{background:#181a1f;color:#cfd3dc;font:13px monospace;margin:0;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center;height:100vh}
#frame{image-rendering:pixelated;max-width:90%;max-height:90vh;cursor:grab}
#panel{width:240px;padding:12px;background:#20232a;overflow-y:auto}
select,button{width:100%;margin:2px 0;background:#2b2f38;color:#cfd3dc;border:1px solid #444}
label{display:block;margin:1px 0}#stats{white-space:pre;margin-top:8px;color:#8a93a5}
h4{margin:10px 0 4px;color:#e8eaf0}</style></head><body>
<div id="view"><img id="frame" src="/frame.png" draggable="false"></div>
<div id="panel"><h4>Render path</h4><select id="path">__PATH_OPTS__</select>
<h4>Display mode</h4><select id="display">__DISPLAY_OPTS__</select>
<h4>Flags</h4>__FLAG_BOXES__<div id="stats"></div></div>
<script>
const img=document.getElementById('frame');let drag=false,lx=0,ly=0,busy=false;
async function send(m){await fetch('/input',{method:'POST',body:JSON.stringify(m)});}
async function refresh(){if(busy)return;busy=true;
 const r=await fetch('/frame.png?t='+Date.now());const b=await r.blob();
 img.src=URL.createObjectURL(b);
 const s=await (await fetch('/state')).json();
 document.getElementById('stats').textContent=JSON.stringify(s,null,1);
 busy=false;}
img.onmousedown=e=>{drag=true;lx=e.clientX;ly=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 send({orbit:[(e.clientX-lx)*0.01,(e.clientY-ly)*0.01]});lx=e.clientX;ly=e.clientY};
img.onwheel=e=>{e.preventDefault();send({zoom:e.deltaY*0.01})};
window.onkeydown=e=>{const k=e.key.toLowerCase();const m={w:[1,0,0],s:[-1,0,0],
 a:[0,-1,0],d:[0,1,0],q:[0,0,-1],e:[0,0,1]}[k];if(m)send({fly:m.map(x=>x*0.25)})};
document.getElementById('path').onchange=e=>send({path:e.target.value});
document.getElementById('display').onchange=e=>send({display:e.target.value});
document.querySelectorAll('input[type=checkbox]').forEach(c=>
 c.onchange=()=>send({toggle:c.id}));
setInterval(refresh,250);refresh();
</script></body></html>"""


class Viewer:
    """Owns the renderer + camera behind a lock; translates input
    messages into camera / settings mutations (Input.cpp analog)."""

    def __init__(self, renderer, camera, pipeline: bool = True):
        self.renderer = renderer
        self.camera = camera
        self.lock = threading.Lock()
        self.frame_ms = deque(maxlen=30)
        # one frame in flight (Renderer.cpp frames-in-flight analog):
        # serve frame N while N+1 renders
        self.pipeline = pipeline
        self._pending = None

    # --- input (EditorCamera controls: orbit/zoom/pan/fly) --------------
    def handle_input(self, msg: dict) -> dict:
        with self.lock:
            if "orbit" in msg:
                dyaw, dpitch = (float(x) for x in msg["orbit"])
                self.camera.orbit(dyaw, dpitch)
            if "zoom" in msg:
                self.camera.zoom(float(msg["zoom"]))
            if "pan" in msg:
                dx, dy = (float(x) for x in msg["pan"])
                self.camera.pan(dx, dy)
            if "fly" in msg:
                f, s, l = (float(x) for x in msg["fly"])
                self.camera.fly(fwd=f, strafe=s, lift=l)
            if "path" in msg:
                self._drop_pending()
                self.renderer.switch_path(_PATHS[str(msg["path"])])
            if "display" in msg:
                self._drop_pending()
                mode = DisplayMode[str(msg["display"]).upper()]
                self.renderer.apply_settings(display_mode=mode)
            if "toggle" in msg:
                self._drop_pending()
                flag = RenderFlags[str(msg["toggle"]).upper()]
                self.renderer.apply_settings(
                    flags=self.renderer.settings.flags ^ flag)
        return self.state()

    def _drop_pending(self):
        """Flush the in-flight frame before a settings/path switch (it
        was rendered under the old pipeline)."""
        if self._pending is not None:
            self._pending = None

    def frame_png(self) -> bytes:
        with self.lock:
            t0 = time.perf_counter()
            cam = self.camera.step(
                taa_enabled=bool(self.renderer.settings.flags
                                 & RenderFlags.TAA))
            if self.pipeline:
                prev = self._pending
                self._pending = self.renderer.render(cam)
                img = (prev if prev is not None
                       else self._pending).cpu().numpy()
            else:
                img = self.renderer.render_np(cam)
            self.frame_ms.append(1000.0 * (time.perf_counter() - t0))
            return encode_png(np.clip(img, 0.0, 1.0))

    def state(self) -> dict:
        st = self.renderer.settings
        ms = float(np.mean(self.frame_ms)) if self.frame_ms else None
        return {
            "path": RenderPathType(st.path).name.lower(),
            "display": DisplayMode(st.display_mode).name.lower(),
            "flags": [f.name for f in RenderFlags if f.name != "NONE"
                      and st.flags & f],
            "size": [st.width, st.height],
            "frame": self.renderer.frame_count,
            "ms_per_frame": round(ms, 1) if ms is not None else None,
            **self.renderer.frame_stats(),
        }

    def page(self) -> str:
        st = self.renderer.settings
        popts = "".join(
            f'<option value="{k}"{" selected" if v == st.path else ""}>'
            f'{k}</option>' for k, v in _PATHS.items())
        dopts = "".join(
            f'<option value="{m.name.lower()}"'
            f'{" selected" if m == st.display_mode else ""}>'
            f'{m.name.lower()}</option>' for m in DisplayMode)
        boxes = "".join(
            f'<label><input type="checkbox" id="{n}"'
            f'{" checked" if st.flags & RenderFlags[n] else ""}> {n}'
            f'</label>' for n in _TOGGLABLE)
        return (_PAGE.replace("__PATH_OPTS__", popts)
                .replace("__DISPLAY_OPTS__", dopts)
                .replace("__FLAG_BOXES__", boxes))


def make_server(viewer: Viewer, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route into CHIMERA logging
            _log().debug("viewer http", request=fmt % args)

        def _reply(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            route = self.path.split("?")[0]
            try:
                if route == "/":
                    self._reply(200, "text/html",
                                viewer.page().encode("utf-8"))
                elif route == "/frame.png":
                    self._reply(200, "image/png", viewer.frame_png())
                elif route == "/state":
                    self._reply(200, "application/json",
                                json.dumps(viewer.state()).encode())
                else:
                    self._reply(404, "text/plain", b"not found")
            except Exception as e:  # surface render errors to the client
                self._reply(500, "text/plain", repr(e).encode())

        def do_POST(self):
            if self.path.split("?")[0] != "/input":
                self._reply(404, "text/plain", b"not found")
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                msg = json.loads(self.rfile.read(n) or b"{}")
                out = viewer.handle_input(msg)
                self._reply(200, "application/json",
                            json.dumps(out).encode())
            except Exception as e:
                self._reply(400, "text/plain", repr(e).encode())

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    from ..core.config import RenderSettings
    from ..runtime.renderer import Renderer
    from .main import build_scene, default_camera, device_arg, parse_flags

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cube")
    ap.add_argument("--file", default=None)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--path", default="hybrid", choices=list(_PATHS))
    ap.add_argument("--flags", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    host_scene = build_scene(args.scene, args.file)
    data = host_scene.build(device_arg(args.device))
    flags = parse_flags(args.flags, _PATHS[args.path])
    settings = RenderSettings(width=args.size, height=args.size,
                              path=_PATHS[args.path], flags=flags)
    renderer = Renderer.for_scene(settings, data)
    camera = default_camera(args.scene, args.size, args.size)
    viewer = Viewer(renderer, camera)
    server = make_server(viewer, args.host, args.port)
    print(f"viewer at http://{server.server_address[0]}:"
          f"{server.server_address[1]}/  (ctrl-c to stop)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
