"""Dynamic scene updates on the scene's device
(hybridrenderer_tpu/scene/dynamic.py): per-frame entity transforms
re-synced into the SceneData, then the tracer refit (SceneTracer.refit)
with the topology frozen.

* ``build_maps(scene, device)``: host, once per topology: vertex →
  instance, per-instance local boxes, light-CDF slots.
* ``update_transforms(data, maps, transforms)``: new instance matrices →
  new SceneData with the inverse and normal transforms, world boxes,
  world vertex positions, triangle soup, light CDF and the attribute
  rows recomputed; ``prev_transform`` takes the old current transforms,
  so the G-buffer's motion vectors see one frame of object motion.
* ``update_transforms_subset``: the same for the dirty vertex and
  triangle rows only (the instance table is small and recomputed whole).
* ``DynamicScene``: entity-level transforms, ``commit`` and
  ``commit_and_render``.

All plain PyTorch; no kernel of the port runs here. The reference pads
its dirty index arrays to multiples of 4096 so that its jit traces are
reused; eager PyTorch needs no padding, and the port passes the dirty
rows as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from . import schema


@dataclasses.dataclass
class DynamicMaps:
    """Static per-topology index maps of the transform updates."""

    vertex_instance: Any   # (V,) i32 owning (first) instance per vertex
    local_lo: Any          # (N, 3) f32 per-instance local-space box
    local_hi: Any          # (N, 3)
    instance_entity: Any   # (N,) i32 entity id per instance row
    cdf_tri: Any           # (C,) i32 triangle id per light-CDF slot
    cdf_seg_start: Any     # (C,) i32 slot index of the segment start


def build_maps(scene, device) -> DynamicMaps:
    """Host map build on a built scene (``scene.build()`` keeps the
    topology record ``_built``); the maps go to ``device``."""
    built = getattr(scene, "_built", None)
    if built is None:
        raise ValueError("scene.build() must run before build_maps()")
    rows = built["rows"]
    mesh_voffset = built["mesh_voffset"]

    total_v = sum(m.num_vertices for m in scene.meshes)
    vertex_instance = np.zeros((total_v,), np.int32)
    seen = set()
    for i, (mid, _t, _p) in enumerate(rows):
        if mid in seen:
            continue  # the world bake uses the FIRST instance
        seen.add(mid)  # (scene._world_positions)
        lo = mesh_voffset[mid]
        vertex_instance[lo:lo + scene.meshes[mid].num_vertices] = i

    n = len(rows)
    local_lo = np.zeros((n, 3), np.float32)
    local_hi = np.zeros((n, 3), np.float32)
    for i, (mid, _t, _p) in enumerate(rows):
        local_lo[i], local_hi[i] = scene.meshes[mid].local_aabb()

    inst_ent = np.zeros((n,), np.int32)
    k = 0
    for eid, ent in enumerate(scene.entities):
        for _ in ent.mesh_ids:
            inst_ent[k] = eid
            k += 1

    # light-CDF slots, in build_light_table's iteration order
    t_inst = built["t_inst"]
    cdf_tri_l, seg_start_l = [], []
    for inst_id, (mid, _t, _p) in enumerate(rows):
        mat = scene.materials[scene.meshes[mid].material]
        if np.linalg.norm(np.asarray(mat.emission)) < 1e-3:
            continue
        tri_ids = np.flatnonzero(t_inst == inst_id)
        if len(tri_ids) == 0:
            continue
        off = sum(len(x) for x in cdf_tri_l)
        seg_start_l.append(np.full(len(tri_ids), off, np.int32))
        cdf_tri_l.append(tri_ids.astype(np.int32))
    empty = np.zeros((0,), np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return DynamicMaps(
        vertex_instance=t(vertex_instance), local_lo=t(local_lo),
        local_hi=t(local_hi), instance_entity=t(inst_ent),
        cdf_tri=t(np.concatenate(cdf_tri_l) if cdf_tri_l else empty),
        cdf_seg_start=t(np.concatenate(seg_start_l) if seg_start_l
                        else empty))


def _update_instances(data, maps: DynamicMaps, transforms,
                      prev_transforms=None):
    """The whole instance table recomputed (N is small): inverses,
    normal matrices and world boxes of every instance. The inverses come
    from ``torch.linalg.inv_ex``, which checks nothing on the host, so
    the update needs no device sync."""
    inst = data.instances
    prev = inst.transform if prev_transforms is None else prev_transforms
    tf = transforms.to(torch.float32)
    n = tf.shape[0]
    inv = torch.linalg.inv_ex(tf).inverse
    nrm4 = torch.eye(4, dtype=torch.float32, device=tf.device).repeat(n, 1, 1)
    nrm4[:, :3, :3] = torch.linalg.inv_ex(tf[:, :3, :3]).inverse \
        .transpose(1, 2)

    # world boxes from the 8 local corners
    combos = torch.tensor([[(c >> a) & 1 for a in range(3)]
                           for c in range(8)], dtype=torch.float32,
                          device=tf.device)
    corners = (maps.local_lo[:, None, :] * (1.0 - combos[None])
               + maps.local_hi[:, None, :] * combos[None])   # (N, 8, 3)
    wc = torch.einsum("nij,nkj->nki", tf[:, :3, :3], corners) \
        + tf[:, None, :3, 3]
    return tf, dataclasses.replace(
        inst, transform=tf, inverse_transform=inv, normal_transform=nrm4,
        prev_transform=prev, aabb_min=wc.amin(dim=1), aabb_max=wc.amax(dim=1))


def _update_light_cdf(data, maps: DynamicMaps, soup):
    lights = data.lights
    if maps.cdf_tri.shape[0] > 0 and \
            lights.cdf.shape[0] == maps.cdf_tri.shape[0]:
        tri = maps.cdf_tri.long()
        a, b, c = soup.v0[tri], soup.v1[tri], soup.v2[tri]
        areas = 0.5 * torch.linalg.norm(torch.cross(b - a, c - a, dim=-1),
                                        dim=-1)
        cs = torch.cumsum(areas, dim=0)
        seg = maps.cdf_seg_start.long()
        base = torch.where(seg > 0, cs[torch.clamp(seg - 1, min=0)], 0.0)
        lights = dataclasses.replace(lights, cdf=(cs - base).float())
    return lights


def _world(tf, vertex_instance, position):
    """World positions of vertices with their instances' transforms."""
    vt = tf[vertex_instance.long()]
    return torch.einsum("vij,vj->vi", vt[:, :3, :3], position) \
        + vt[:, :3, 3]


def update_transforms(data, maps: DynamicMaps, transforms,
                      prev_transforms: Optional[Any] = None):
    """New per-instance transforms (N, 4, 4), in instance order → new
    SceneData. ``prev_transforms`` defaults to the data's current
    transforms."""
    tf, new_inst = _update_instances(data, maps, transforms, prev_transforms)
    pw = _world(tf, maps.vertex_instance, data.vertices.position)
    new_verts = dataclasses.replace(data.vertices, world_position=pw)
    soup = data.triangles
    new_soup = dataclasses.replace(soup, v0=pw[soup.i0.long()],
                                   v1=pw[soup.i1.long()],
                                   v2=pw[soup.i2.long()])
    return dataclasses.replace(
        data, instances=new_inst, vertices=new_verts, triangles=new_soup,
        lights=_update_light_cdf(data, maps, new_soup),
        attr_rows=schema.build_attr_rows(new_verts, new_inst, new_soup,
                                         data.materials),
        raster_rows=schema.build_raster_rows(new_verts, new_inst, new_soup,
                                             data.materials))


def update_transforms_subset(data, maps: DynamicMaps, transforms,
                             vert_idx, tri_idx, update_lights: bool = False,
                             prev_transforms: Optional[Any] = None):
    """The dirty-only update: ``vert_idx`` (Dv,) and ``tri_idx`` (Dt,) are
    the vertex and triangle rows that move (DynamicScene computes them
    from the static topology); only they are recomputed, and the result
    equals ``update_transforms``'s there. ``update_lights`` rebakes the
    light CDF (the caller passes True only when a dirty instance is
    emissive).

    As in the reference, a triangle outside ``tri_idx`` keeps its
    attribute and raster rows, whose previous transform and previous
    world positions are then one update old: an instance that stops
    moving keeps last frame's motion in the raster rows until it moves
    again (ROADMAP queue 3)."""
    tf, new_inst = _update_instances(data, maps, transforms, prev_transforms)
    vi, ti = vert_idx.long(), tri_idx.long()
    pw = data.vertices.world_position.clone()
    pw[vi] = _world(tf, maps.vertex_instance[vi], data.vertices.position[vi])
    new_verts = dataclasses.replace(data.vertices, world_position=pw)

    soup = data.triangles
    corners = {}
    for name, idx in (("v0", soup.i0), ("v1", soup.i1), ("v2", soup.i2)):
        v = getattr(soup, name).clone()
        v[ti] = pw[idx[ti].long()]
        corners[name] = v
    new_soup = dataclasses.replace(soup, **corners)

    attr = data.attr_rows.clone()
    attr[ti] = schema.build_attr_rows(new_verts, new_inst, new_soup,
                                      data.materials, tris=ti)
    rattr = data.raster_rows.clone()
    rattr[ti] = schema.build_raster_rows(new_verts, new_inst, new_soup,
                                         data.materials, tris=ti)
    return dataclasses.replace(
        data, instances=new_inst, vertices=new_verts, triangles=new_soup,
        lights=_update_light_cdf(data, maps, new_soup) if update_lights
        else data.lights, attr_rows=attr, raster_rows=rattr)


def build_host_ranges(scene) -> dict:
    """Host topology ranges for dirty sets, once per topology: the
    triangle range of each instance, the vertex range and first instance
    of each mesh, and which instances are emissive."""
    built = scene._built
    rows, mesh_voffset = built["rows"], built["mesh_voffset"]
    t_inst = built["t_inst"]
    n = len(rows)
    first_inst = {}
    for i, (mid, _t, _p) in enumerate(rows):
        first_inst.setdefault(mid, i)
    inst_mesh = np.array([r[0] for r in rows], np.int32)
    emissive = np.array([
        np.linalg.norm(np.asarray(
            scene.materials[scene.meshes[mid].material].emission)) > 1e-3
        for mid in inst_mesh], bool)
    return dict(tri_start=np.searchsorted(t_inst, np.arange(n)),
                tri_end=np.searchsorted(t_inst, np.arange(n) + 1),
                inst_mesh=inst_mesh, first_inst=first_inst,
                emissive=emissive, vstart=np.array(mesh_voffset, np.int32),
                vcount=np.array([m.num_vertices for m in scene.meshes],
                                np.int32),
                n_tris=len(t_inst))


class DynamicScene:
    """Entity-level dynamic updates of a built host Scene and its
    Renderer: set entity transforms, then ``commit()`` updates the
    renderer's scene on its device (instances, world geometry, light
    CDF, attribute rows) and refits its tracer, the per-frame
    Scene::OnUpdate. An update touches only the rows of the dirty
    entities while they hold at most half the scene's triangles, and
    re-bakes everything above that; the light CDF is rebaked only when a
    dirty instance is emissive."""

    def __init__(self, scene, renderer):
        self.scene = scene
        self.renderer = renderer
        self.device = renderer.scene.device
        self.maps = build_maps(scene, self.device)
        self.ranges = build_host_ranges(scene)
        self._instance_entity = self.maps.instance_entity.cpu().numpy()
        self._transforms = np.stack(
            [r[1] for r in scene._built["rows"]]).astype(np.float32)
        self._dirty_entities = set()
        self._idx_cache = {}

    def set_entity_transform(self, entity_id: int, transform):
        m = np.asarray(transform, np.float32)
        self._transforms[self._instance_entity == entity_id] = m
        self.scene.entities[entity_id].transform = m
        self._dirty_entities.add(int(entity_id))

    def _dirty_indices(self, key):
        """(vert_idx, tri_idx, update_lights) of the dirty entity set
        ``key``, the index arrays on the device; cached, so an entity
        that moves every frame costs one host computation."""
        cached = self._idx_cache.get(key)
        if cached is not None:
            return cached
        rg = self.ranges
        dirty_inst = np.isin(self._instance_entity, list(key))
        # meshes whose world bake moves: their FIRST instance is dirty
        dirty_mesh = {int(rg["inst_mesh"][i])
                      for i in np.flatnonzero(dirty_inst)
                      if rg["first_inst"][int(rg["inst_mesh"][i])] == i}
        # triangles referencing a moved mesh's vertices re-bake too
        # (instances of a shared mesh see the first instance's bake)
        tri_dirty = dirty_inst | np.isin(rg["inst_mesh"],
                                         list(dirty_mesh) or [-1])
        vsegs = [np.arange(rg["vstart"][m], rg["vstart"][m] + rg["vcount"][m])
                 for m in sorted(dirty_mesh)]
        tsegs = [np.arange(rg["tri_start"][i], rg["tri_end"][i])
                 for i in np.flatnonzero(tri_dirty)]
        idx = lambda segs: torch.from_numpy(
            np.concatenate(segs) if segs else np.zeros((0,), np.int64)
        ).to(self.device)
        out = (idx(vsegs), idx(tsegs), bool(rg["emissive"][dirty_inst].any()))
        self._idx_cache[key] = out
        return out

    def _pending(self):
        """The dirty set's update arguments, the transforms on the device:
        (transforms, vert_idx, tri_idx, use_subset, update_lights)."""
        vert_idx, tri_idx, lights = self._dirty_indices(
            frozenset(self._dirty_entities))
        n_tri = tri_idx.shape[0]
        use_subset = bool(n_tri and n_tri <= self.ranges["n_tris"] // 2)
        tf = torch.from_numpy(self._transforms.copy())
        if self.device.type == "cuda":
            # a pinned staging copy keeps the upload off the host's path
            tf = tf.pin_memory().to(self.device, non_blocking=True)
        return tf, vert_idx, tri_idx, use_subset, lights

    def commit(self):
        """Update the renderer's scene and refit its tracer
        (``Renderer.update_dynamic``)."""
        if not self._dirty_entities:
            return
        tf, vert_idx, tri_idx, use_subset, lights = self._pending()
        self.renderer.update_dynamic(self.maps, tf, vert_idx, tri_idx,
                                     use_subset, lights)
        self._dirty_entities.clear()

    def commit_and_render(self, cam_state, **kw):
        """``commit()``, then the frame."""
        self.commit()
        return self.renderer.render(cam_state, **kw)
