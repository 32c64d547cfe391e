"""The port's app on the CPU: the CLI (``--device cpu``) against the
reference's (its Mermaid text, a short render), and the HTTP viewer
driven over a socket through the reference's five viewer cases (page,
frame and state; orbit; display mode; flag toggle; bad input)."""
import contextlib
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hybridrenderer_tpu.app import main as ref_main
from hybridrenderer_tpu_torch.app import main as port_main
from hybridrenderer_tpu_torch.app.viewer import Viewer, make_server
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import (DisplayMode, RenderFlags,
                                                 RenderPathType)
from hybridrenderer_tpu_torch.runtime.output import read_png
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import scene as scenes

from .torch_parity import one_torch_thread


@pytest.fixture(autouse=True)
def _one_thread():
    with one_torch_thread():
        yield


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("path", ["forward", "hybrid", "raytraced"])
def test_cli_mermaid_equals_reference(path):
    """``--mermaid`` prints the path's render graph as the reference does,
    line for line."""
    argv = ["--scene", "cube", "--size", "32", "--path", path, "--mermaid",
            "--device", "cpu"]
    assert _stdout(port_main.main, argv) == _stdout(ref_main.main, argv)


def test_cli_renders_frames_on_the_cpu(tmp_path):
    """Two hybrid frames with --stats, written as seq_000.png and
    seq_001.png; the frame stats line per frame."""
    out = _stdout(port_main.main, [
        "--scene", "cube", "--size", "32", "--path", "hybrid", "--frames",
        "2", "--orbit", "0.1", "--stats", "--device", "cpu", "--out",
        str(tmp_path / "seq.png")])
    assert "frame 1: {'instances_drawn'" in out and "on cpu" in out
    for i in range(2):
        img = read_png(str(tmp_path / f"seq_{i:03d}.png"))
        assert img.shape == (32, 32, 3) and img.std() > 0


def test_cli_cuda_without_a_card_is_an_error(monkeypatch):
    """--device cuda (the default) with no CUDA device stops with an
    error; it never renders on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        port_main.main(["--scene", "cube", "--size", "32"])


@pytest.fixture(scope="module")
def server_url():
    with one_torch_thread():
        data = scenes.cube_scene().build("cpu")
        settings = RenderSettings(
            width=64, height=64, path=RenderPathType.FORWARD,
            flags=RenderFlags.LIGHT | RenderFlags.IBL)
        renderer = Renderer.for_scene(settings, data)
        cam = OrbitCamera(width=64, height=64, distance=7.0, pitch=0.45,
                          yaw=0.6, focal_point=(0, 0.7, 0))
        viewer = Viewer(renderer, cam)
        srv = make_server(viewer, port=0)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        host, port = srv.server_address
        yield f"http://{host}:{port}", viewer
        srv.shutdown()
        srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.read()


def _post(url, msg):
    req = urllib.request.Request(url, data=json.dumps(msg).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def test_page_and_frame(server_url):
    url, _viewer = server_url
    status, body = _get(url + "/")
    assert status == 200 and b"HybridRenderer" in body
    status, png = _get(url + "/frame.png")
    assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"
    status, raw = _get(url + "/state")
    state = json.loads(raw)
    assert state["path"] == "forward" and state["size"] == [64, 64]
    assert state["frame"] >= 1


def test_orbit_changes_frame(server_url):
    url, _viewer = server_url
    _, png_a = _get(url + "/frame.png")
    _post(url + "/input", {"orbit": [0.8, 0.2], "zoom": -1.0})
    # one frame in flight: the first fetch after an input may serve the
    # frame rendered before it; the second shows the moved camera
    _get(url + "/frame.png")
    _, png_b = _get(url + "/frame.png")
    assert png_a != png_b


def test_display_mode_switch(server_url):
    url, viewer = server_url
    _, state = _post(url + "/input", {"display": "normal"})
    assert state["display"] == "normal"
    assert viewer.renderer.settings.display_mode == DisplayMode.NORMAL
    _, png = _get(url + "/frame.png")
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    _post(url + "/input", {"display": "final"})


def test_flag_toggle(server_url):
    url, viewer = server_url
    before = viewer.renderer.settings.flags
    _, state = _post(url + "/input", {"toggle": "IBL"})
    assert viewer.renderer.settings.flags == before ^ RenderFlags.IBL
    assert "IBL" not in state["flags"]
    _post(url + "/input", {"toggle": "IBL"})
    assert viewer.renderer.settings.flags == before


def test_bad_input_is_400_not_crash(server_url):
    url, _viewer = server_url
    req = urllib.request.Request(url + "/input", data=b"not json",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    status, _ = _get(url + "/state")
    assert status == 200
    assert np.isfinite(json.loads(_get(url + "/state")[1])["frame"])
