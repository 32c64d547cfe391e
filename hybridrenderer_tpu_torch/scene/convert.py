"""Carry a scene over from the JAX package.

``scene_from_numpy`` takes the JAX ``SceneData`` flattened to nested
dicts of numpy arrays (field name → array, one dict per sub-table; the
caller does the flattening) and gives the port's ``SceneData`` on a
stated device, so both packages render from identical arrays. Fields the
port does not use (the reference's TPU gather tables) are ignored.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import schema


def _table(cls, d):
    return cls(**{f.name: torch.from_numpy(np.array(d[f.name]))
                  for f in dataclasses.fields(cls)})


def scene_from_numpy(tree, device="cpu") -> schema.SceneData:
    data = schema.SceneData(
        materials=_table(schema.MaterialTable, tree["materials"]),
        instances=_table(schema.InstanceTable, tree["instances"]),
        vertices=_table(schema.VertexArrays, tree["vertices"]),
        indices=torch.from_numpy(np.array(tree["indices"])),
        triangles=_table(schema.TriangleSoup, tree["triangles"]),
        lights=_table(schema.LightTable, tree["lights"]),
        textures=schema.TextureStack(
            data=torch.from_numpy(np.array(tree["textures"]["data"],
                                           np.float32)),
            sizes=torch.from_numpy(np.array(tree["textures"]["sizes"]))),
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
