"""Carry a scene over from the JAX package.

``scene_from_numpy`` takes the JAX ``SceneData`` flattened to nested
dicts of numpy arrays (field name → array, one dict per sub-table; the
caller does the flattening) and gives the port's ``SceneData`` on a
device, the card unless the caller asks for the CPU, so both packages
render from identical arrays. Fields the port does not use (the
reference's TPU gather tables, its texture quads and window atlas) are
ignored; the texture stack's ``slot_usage`` is derived from the
materials, as ``Scene.build`` derives it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import schema


def _table(cls, d):
    return cls(**{f.name: torch.from_numpy(np.array(d[f.name]))
                  for f in dataclasses.fields(cls)})


def _texture_stack(tex) -> schema.TextureStack:
    """The port's stack from the reference's: its f32 texels and sizes
    (the quad-texel bake and window atlas give the same samples and are
    dropped). A u8 stack (the reference's HR_TEX_BITS=8) or one without
    its texels is refused: the port samples f32 texels only."""
    data = tex.get("data")
    if data is None:
        raise ValueError("scene_from_numpy: the texture stack has no "
                         "'data' texels (a quad-only stack); the port "
                         "needs the f32 (N, H, W, 4) texels")
    data = np.asarray(data)
    if data.dtype != np.float32:
        raise ValueError(f"scene_from_numpy: texture texels of dtype "
                         f"{data.dtype} (the reference's u8 storage, "
                         f"HR_TEX_BITS=8); the port needs float32 texels")
    return schema.TextureStack(data=torch.from_numpy(data.copy()),
                               sizes=torch.from_numpy(np.array(tex["sizes"])))


def scene_from_numpy(tree, device="cuda") -> schema.SceneData:
    materials = _table(schema.MaterialTable, tree["materials"])
    data = schema.SceneData(
        materials=materials,
        instances=_table(schema.InstanceTable, tree["instances"]),
        vertices=_table(schema.VertexArrays, tree["vertices"]),
        indices=torch.from_numpy(np.array(tree["indices"])),
        triangles=_table(schema.TriangleSoup, tree["triangles"]),
        lights=_table(schema.LightTable, tree["lights"]),
        textures=_texture_stack(tree["textures"]).finalized(materials),
        sun=_table(schema.SunLight, tree["sun"]),
        sky_texture=int(tree["sky_texture"]),
        blue_noise=torch.from_numpy(np.array(tree["blue_noise"])),
        has_alpha_test=bool(tree["has_alpha_test"]),
        has_sky_texture=bool(tree["has_sky_texture"]),
    ).to(device)
    for name, build in (("attr_rows", schema.build_attr_rows),
                        ("raster_rows", schema.build_raster_rows)):
        rows = tree.get(name)
        if rows is None:
            rows = build(data.vertices, data.instances, data.triangles,
                         data.materials)
        else:
            rows = torch.from_numpy(np.array(rows)).to(device)
        setattr(data, name, rows)
    return data
