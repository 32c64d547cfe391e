"""Port vs reference: the scene loaders. OBJ (+ MTL; quads, negative
indices, a textured material), .gltf and .glb give the reference's host
scene and built scene arrays exactly, textures included; the native
tokenizer and the Python one give the same triangles; the .hdr sky
reader; PNG decoding without PIL (the GPU machine has none); and the
textured .glb golden, tests/goldens/textured_gltf_96.png. Every image is
a PNG, so both packages decode the same texels."""
import json
import os
import struct

import numpy as np
import pytest

from hybridrenderer_tpu.core.camera import OrbitCamera as RefCamera
from hybridrenderer_tpu.core.config import RenderSettings as RefSettings
from hybridrenderer_tpu.core.types import RenderFlags as RefFlags
from hybridrenderer_tpu.core.types import RenderPathType as RefPath
from hybridrenderer_tpu.ops import raster as ref_raster
from hybridrenderer_tpu.runtime.renderer import Renderer as RefRenderer
from hybridrenderer_tpu.scene import loader as ref_loader
from hybridrenderer_tpu.scene import loader_native as ref_loader_native
from hybridrenderer_tpu_torch.core.camera import OrbitCamera
from hybridrenderer_tpu_torch.core.config import RenderSettings
from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8, write_png
from hybridrenderer_tpu_torch.runtime.renderer import Renderer
from hybridrenderer_tpu_torch.scene import loader, loader_obj

from .test_loaders import _minimal_gltf
from .test_torch_scene import DERIVED, _fields, _lookup
from .torch_parity import (clear_reference_knobs, flatten, off_edge_errors,
                          one_torch_thread)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GLB = os.path.join(GOLDEN_DIR, "textured_tri.glb")

OBJ = """# two materials, a quad, negative indices, partial vt / vn
mtllib scene.mtl
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 2 0 1
v 3 0.5 1
v 2 1.5 0.5
vt 0 0
vt 1 0
vt 1 1
vt 0 1
vn 0 0 1
usemtl leafy
f 1/1/1 2/2/1 3/3/1 4/4/1
usemtl stone
f -3/1 -2/2 -1/3
f 5 7 6
"""
MTL = """newmtl leafy
Kd 0.8 0.6 0.4
Ke 0.1 0.0 0.0
Ns 250
map_Kd leaf.png
bump leaf_n.png
newmtl stone
Kd 0.3 0.3 0.35
Pr 0.7
Pm 0.2
d 0.9
map_Pr rough.png
"""


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    monkeypatch.delenv("HR_TEX_MAX", raising=False)
    with one_torch_thread():
        yield


def _png(path, seed, shape):
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    write_png(str(path), img)
    return img


def _obj_scene(tmp_path):
    (tmp_path / "scene.obj").write_text(OBJ)
    (tmp_path / "scene.mtl").write_text(MTL)
    _png(tmp_path / "leaf.png", 0, (12, 20, 4))
    _png(tmp_path / "leaf_n.png", 1, (8, 8, 3))
    _png(tmp_path / "rough.png", 2, (16, 6, 4))
    return str(tmp_path / "scene.obj")


def _assert_scenes_equal(sc, ref_sc):
    """Host scenes (meshes, materials, entities) and built scenes."""
    assert len(sc.meshes) == len(ref_sc.meshes) > 0
    for m, rm in zip(sc.meshes, ref_sc.meshes):
        for f in ("positions", "normals", "tangents", "uvs"):
            np.testing.assert_array_equal(getattr(m, f), getattr(rm, f),
                                          err_msg=f)
        np.testing.assert_array_equal(m.indices.reshape(-1),
                                      np.asarray(rm.indices).reshape(-1))
        assert m.material == rm.material and m.name == rm.name
    assert [vars(m) for m in sc.materials] == [
        {k: v for k, v in vars(m).items() if k != "_tex_paths"}
        for m in ref_sc.materials]
    for e, re in zip(sc.entities, ref_sc.entities):
        np.testing.assert_array_equal(e.transform, re.transform)
    tree = flatten(ref_sc.build())
    data = sc.build("cpu")
    for n, arr in _fields(data):
        ref_arr = _lookup(tree, n)
        if n in DERIVED:
            np.testing.assert_allclose(arr, ref_arr, rtol=1e-6, atol=1e-6,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(arr, ref_arr, err_msg=n)
    assert data.textures.slot_usage == tree["textures"]["slot_usage"]
    return data


@pytest.mark.parametrize("native", [True, False])
def test_obj_matches_reference(tmp_path, monkeypatch, native):
    """The native tokenizer against the reference's native path, the
    Python one (``load_obj_python``) against its Python path."""
    path = _obj_scene(tmp_path)
    if not native:
        monkeypatch.setattr(ref_loader_native, "available", lambda: False)
        monkeypatch.setattr(loader_obj, "load_obj",
                            loader_obj.load_obj_python)
    elif not ref_loader_native.available():
        pytest.skip("the reference's native OBJ loader did not build")
    data = _assert_scenes_equal(loader.load_scene_file(path),
                                ref_loader.load_scene_file(path))
    assert data.textures.data.shape == (3, 1024, 1024, 4)
    assert data.textures.slot_usage == (True, False, True, True)


def test_native_matches_python(tmp_path):
    """The two tokenizers give the same triangles, the same materials and
    texture paths; their vertex orders differ."""
    path = _obj_scene(tmp_path)
    a = loader_obj.load_obj(path)
    b = loader_obj.load_obj_python(path)
    assert a[1] == b[1] and a[2] == b[2]
    assert len(a[0]) == len(b[0]) == 2
    for ma, mb in zip(a[0], b[0]):
        assert ma.num_triangles == mb.num_triangles

        def corners(m):
            tri = m.indices.reshape(-1, 3)
            return np.sort(np.concatenate(
                [m.positions[tri].reshape(len(tri), -1),
                 m.uvs[tri].reshape(len(tri), -1)], -1), axis=0)

        np.testing.assert_array_equal(corners(ma), corners(mb))


def test_gltf_matches_reference(tmp_path):
    path = _minimal_gltf(tmp_path)
    _assert_scenes_equal(loader.load_scene_file(path),
                         ref_loader.load_scene_file(path))


def test_glb_texture_stack_matches_reference():
    """tests/goldens/textured_tri.glb: its colour texture, a PNG beside
    it, stacked padded to 1024², and the scene around it."""
    data = _assert_scenes_equal(loader.load_scene_file(GLB),
                                ref_loader.load_scene_file(GLB))
    tex = read_png(os.path.join(GOLDEN_DIR, "textured_tri_tex.png"))
    h, w = tex.shape[:2]
    assert data.textures.sizes.tolist() == [[h, w]]
    assert data.materials.colour_texture.tolist() == [0]
    assert data.textures.slot_usage == (True, False, False, False)


def _glb_with_embedded_png(png_bytes):
    """textured_tri.glb with its image embedded as a buffer view."""
    with open(GLB, "rb") as f:
        blob = f.read()
    jlen = struct.unpack("<I", blob[12:16])[0]
    gltf = json.loads(blob[20:20 + jlen])
    blen = struct.unpack("<I", blob[20 + jlen:24 + jlen])[0]
    binary = blob[28 + jlen:28 + jlen + blen]
    pad = (-len(binary)) % 4
    binary += b"\0" * pad
    gltf["bufferViews"].append({"buffer": 0, "byteOffset": len(binary),
                                "byteLength": len(png_bytes)})
    gltf["images"] = [{"bufferView": len(gltf["bufferViews"]) - 1,
                       "mimeType": "image/png"}]
    binary += png_bytes + b"\0" * ((-len(png_bytes)) % 4)
    gltf["buffers"][0]["byteLength"] = len(binary)
    j = json.dumps(gltf).encode()
    j += b" " * ((-len(j)) % 4)
    total = 12 + 8 + len(j) + 8 + len(binary)
    return (struct.pack("<III", 0x46546C67, 2, total)
            + struct.pack("<II", len(j), 0x4E4F534A) + j
            + struct.pack("<II", len(binary), 0x004E4942) + binary)


def test_glb_embedded_image(tmp_path):
    """An image embedded in the .glb decodes to the texels of the same
    PNG as a file (the reference skips embedded images)."""
    with open(os.path.join(GOLDEN_DIR, "textured_tri_tex.png"), "rb") as f:
        png = f.read()
    path = tmp_path / "embedded.glb"
    path.write_bytes(_glb_with_embedded_png(png))
    sc = loader.load_scene_file(str(path), max_texture_size=256)
    ref = loader.load_scene_file(GLB, max_texture_size=256)
    np.testing.assert_array_equal(sc.textures.data.numpy(),
                                  ref.textures.data.numpy())
    assert sc.materials[0].colour_texture == 0


def test_decode_without_pil(tmp_path, monkeypatch):
    """Without PIL the package's PNG reader decodes the same texels (RGB,
    RGBA and grey), and anything but a PNG raises."""
    paths = []
    for k, shape in enumerate(((5, 7, 3), (6, 4, 4), (3, 9))):
        paths.append(str(tmp_path / f"i{k}.png"))
        _png(paths[-1], k, shape)
    with_pil = [loader.decode_image(p, srgb=k == 0)
                for k, p in enumerate(paths)]
    monkeypatch.setattr(loader, "_pil_image", lambda: None)
    for k, p in enumerate(paths):
        np.testing.assert_array_equal(loader.decode_image(p, srgb=k == 0),
                                      with_pil[k])
    jpeg = tmp_path / "x.jpg"
    jpeg.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="PNG"):
        loader.decode_image(str(jpeg), srgb=True)


def _rgbe_file(path, rgbe, rle_rows):
    """A Radiance .hdr: the rows in ``rle_rows`` run-length coded (runs
    and literals), the others flat."""
    h, w, _ = rgbe.shape
    out = [b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n",
           f"-Y {h} +X {w}\n".encode()]
    for y in range(h):
        if y not in rle_rows:
            out.append(rgbe[y].tobytes())
            continue
        out.append(bytes([2, 2, w >> 8, w & 255]))
        for c in range(4):
            ch = rgbe[y, :, c]
            half = w // 2
            out.append(bytes([128 + half, ch[0]]))       # a run
            out.append(bytes([w - half]) + ch[half:].tobytes())  # literals
    path.write_bytes(b"".join(out))


def test_load_hdr_equirect(tmp_path):
    g = np.random.default_rng(4)
    rgbe = g.integers(0, 256, (6, 10, 4), np.uint8)
    rgbe[..., 3] = g.integers(120, 140, (6, 10))
    rgbe[[1, 4], :5] = rgbe[[1, 4], :1]     # runs for the coded rows
    path = tmp_path / "sky.hdr"
    _rgbe_file(path, rgbe, rle_rows=(1, 4))
    got = loader.load_hdr_equirect(str(path))
    np.testing.assert_array_equal(got, ref_loader.load_hdr_equirect(str(path)))
    assert got.shape == (6, 10, 4) and (got[..., 3] == 1.0).all()
    scale = np.ldexp(1.0, rgbe[..., 3].astype(np.int32) - 136)
    np.testing.assert_array_equal(
        got[..., :3], rgbe[..., :3] * scale.astype(np.float32)[..., None])


def test_load_scene_async(tmp_path):
    path = _obj_scene(tmp_path)
    sc = loader.load_scene_async(path).result(timeout=60)
    ref = loader.load_scene_file(path)
    np.testing.assert_array_equal(sc.textures.data.numpy(),
                                  ref.textures.data.numpy())
    assert sc.build("cpu").num_triangles == 4


def test_textured_gltf_golden():
    """The textured .glb through the forward path (LIGHT | IBL), 96x96:
    against the golden, bench.py's gate (16 u8 off edges, p99 2), and
    against the reference's render, 2 u8, p99 1. No SVGF."""
    size = 96
    cam_kw = dict(distance=4.0, pitch=0.3, yaw=0.2)
    r = Renderer.for_scene(RenderSettings(
        width=size, height=size, path=RenderPathType.FORWARD,
        flags=RenderFlags.LIGHT | RenderFlags.IBL),
        loader.load_scene_file(GLB).build("cpu"))
    img = to_u8(r.render_np(OrbitCamera(width=size, height=size,
                                        **cam_kw).step()))
    ref_data = ref_loader.load_scene_file(GLB).build()
    ref = RefRenderer.for_scene(RefSettings(
        width=size, height=size, path=RefPath.FORWARD,
        flags=RefFlags.LIGHT | RefFlags.IBL), ref_data)
    state = RefCamera(width=size, height=size, **cam_kw).step()
    want = to_u8(np.asarray(ref.render(state)))
    soup = ref_data.triangles
    tri = np.asarray(ref_raster.rasterize_scene(
        ref_data.vertices.world_position, soup.i0, soup.i1, soup.i2, state,
        size, size, jitter_enabled=False).tri_id)
    off, p99 = off_edge_errors(
        img, read_png(os.path.join(GOLDEN_DIR, "textured_gltf_96.png")), tri)
    assert off <= 16 and p99 <= 2.0, (off, p99)
    off, p99 = off_edge_errors(img, want, tri)
    assert off <= 2 and p99 <= 1.0, (off, p99)
