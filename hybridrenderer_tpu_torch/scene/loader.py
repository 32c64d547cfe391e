"""Scene files: OBJ / glTF / GLB import, texture decoding and stacking,
asynchronous import and the Radiance .hdr sky
(hybridrenderer_tpu/scene/loader.py).

Textures are decoded to linear float RGBA, colour and emission from
sRGB (a 2.2 power), roughness / metallic and normal maps as stored, and
padded into one (N, S, S, 4) TextureStack. Decoding uses PIL where it is
installed, else the package's own PNG reader: without PIL only PNG
images load, and a texture larger than ``max_texture_size`` raises
(PIL does the downscale).
"""
from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..core.types import INVALID_ID
from ..runtime.output import PNG_SIGNATURE, decode_png
from .scene import Scene
from .schema import TextureStack

# the reference's default cap on a texture's larger side
MAX_TEXTURE_SIZE = 1024
_SRGB_SLOTS = ("colour", "emission")


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def decode_image(src: Union[str, bytes], srgb: bool) -> np.ndarray:
    """An image file's path, or its encoded bytes → (H, W, 4) f32 linear
    RGBA in [0, 1]."""
    Image = _pil_image()
    if Image is not None:
        import io

        img = Image.open(io.BytesIO(src) if isinstance(src, bytes) else src)
        arr = np.asarray(img.convert("RGBA"), np.float32) / 255.0
    else:
        if isinstance(src, str):
            with open(src, "rb") as f:
                src = f.read()
        if src[:8] != PNG_SIGNATURE:
            raise ValueError("without PIL only PNG textures can be "
                             "decoded; this image is not a PNG")
        raw = decode_png(src)
        if raw.shape[-1] <= 2:     # grey, grey + alpha
            grey = np.repeat(raw[..., :1], 3, axis=-1)
            raw = np.concatenate([grey, raw[..., 1:]], -1)
        if raw.shape[-1] == 3:
            raw = np.concatenate(
                [raw, np.full(raw.shape[:2] + (1,), 255, np.uint8)], -1)
        arr = raw.astype(np.float32) / 255.0
    if srgb:
        arr = np.concatenate([np.power(arr[..., :3], 2.2), arr[..., 3:]], -1)
    return arr


def _fit(img: np.ndarray, max_size: int) -> np.ndarray:
    """``img`` scaled down, through PIL, so its larger side is at most
    ``max_size``."""
    h, w = img.shape[:2]
    scale = max(h, w) / max_size
    if scale <= 1.0:
        return img
    Image = _pil_image()
    if Image is None:
        raise ValueError(f"a {w}x{h} texture exceeds max_texture_size "
                         f"{max_size}, and scaling it down needs PIL")
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    im = im.resize((max(1, int(w / scale)), max(1, int(h / scale))))
    return np.asarray(im, np.float32) / 255.0


def build_texture_stack(tex_paths: Dict[int, Dict[str, Union[str, bytes]]],
                        materials, max_size: int = MAX_TEXTURE_SIZE
                        ) -> Optional[TextureStack]:
    """Decode every bound image once (deduplicated, on a thread pool),
    stack them padded to ``max_size``², and set the materials' texture
    ids in place. A path that does not exist binds nothing. → the stack,
    or None where nothing was bound."""
    unique: Dict[Union[str, bytes], int] = {}
    jobs = []
    for slots in tex_paths.values():
        for slot, src in slots.items():
            if src not in unique and (isinstance(src, bytes)
                                      or os.path.exists(src)):
                unique[src] = len(unique)
                jobs.append((src, slot in _SRGB_SLOTS))
    if not unique:
        return None
    with ThreadPoolExecutor(max_workers=max(1, (os.cpu_count() or 2) - 1)
                            ) as pool:
        decoded = list(pool.map(
            lambda job: _fit(decode_image(*job), max_size), jobs))
    S = max_size
    stack = np.zeros((len(decoded), S, S, 4), np.float32)
    sizes = np.ones((len(decoded), 2), np.int32)
    for i, img in enumerate(decoded):
        h, w = min(img.shape[0], S), min(img.shape[1], S)
        stack[i, :h, :w] = img[:h, :w]
        sizes[i] = (h, w)
    attr = {"colour": "colour_texture", "emission": "emission_texture",
            "roughness": "roughness_texture", "normal": "normal_texture"}
    for mat_idx, slots in tex_paths.items():
        for slot, src in slots.items():
            setattr(materials[mat_idx], attr[slot],
                    unique.get(src, INVALID_ID))
    return TextureStack(data=torch.from_numpy(stack),
                        sizes=torch.from_numpy(sizes))


def load_scene_file(path: str, max_texture_size: int = MAX_TEXTURE_SIZE
                    ) -> Scene:
    """OBJ / glTF / GLB → host Scene (``build()`` puts it on the card)."""
    ext = os.path.splitext(path)[1].lower()
    sc = Scene(name=os.path.basename(path))
    if ext == ".obj":
        from .loader_obj import load_obj

        meshes, materials, tex_paths = load_obj(path)
        sc.materials = materials
        for m in meshes:
            sc.add_entity(sc.add_mesh(m), name=m.name)
    elif ext in (".gltf", ".glb"):
        from .loader_gltf import load_gltf

        pairs, materials, tex_paths = load_gltf(path)
        sc.materials = materials
        for mesh, world in pairs:
            sc.add_entity(sc.add_mesh(mesh), world, name=mesh.name)
    else:
        raise ValueError(f"unsupported scene format: {ext}")
    sc.textures = build_texture_stack(tex_paths, sc.materials,
                                      max_texture_size)
    return sc


def load_scene_async(path: str, **kw) -> "Future[Scene]":
    """``load_scene_file`` on a worker thread: poll ``future.done()``
    from the frame loop; ``result()`` raises what the load raised."""
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        return pool.submit(load_scene_file, path, **kw)
    finally:
        pool.shutdown(wait=False)


def load_hdr_equirect(path: str) -> np.ndarray:
    """A Radiance .hdr (RGBE, flat or run-length scanlines) → (H, W, 4)
    f32 linear RGB, alpha 1, for an equirect sky."""
    with open(path, "rb") as f:
        data = f.read()
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad HDR header")
    body = data[pos + 2:]
    nl = body.find(b"\n")
    dims = body[:nl].decode("latin1").split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.zeros((h, w, 4), np.uint8)
    p = nl + 1
    for y in range(h):
        if body[p:p + 2] == b"\x02\x02":  # run-length scanline
            p += 4
            row = np.zeros((4, w), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = body[p]
                    p += 1
                    if count > 128:
                        row[c, x:x + count - 128] = body[p]
                        p += 1
                        x += count - 128
                    else:
                        row[c, x:x + count] = np.frombuffer(
                            body[p:p + count], np.uint8)
                        p += count
                        x += count
            rgbe[y] = row.T
        else:  # flat
            rgbe[y] = np.frombuffer(body[p:p + w * 4], np.uint8).reshape(w, 4)
            p += w * 4
    exp = rgbe[..., 3].astype(np.int32) - 136
    scale = np.ldexp(1.0, exp).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    return np.concatenate([rgb, np.ones((h, w, 1), np.float32)], -1)
