#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases (a failed kernel check is reported and the renders still run,
so one run shows every failure; any failure makes the script exit
non-zero without printing a result):

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a) and the native BVH builder
   (g++), from the sources in this checkout, and the SASS instruction
   and load counts of the SVGF stencils and of K2 / K2c / K2b
   (cuobjdump, where the toolkit has it);
3. kernels: each kernel against its plain PyTorch version on the card,
   on the inputs the render paths hand it at 1920x1080 (K1, K1 vis-only,
   K1v and the K4 stencils at odd sizes too; K1v's entry counts a tile
   and its time on the heaviest tile alone), with the tolerance stated,
   timed with CUDA events beside the least time the card could take
   (bound) and, where one PyTorch call computes the same function, that
   call's time (library); and the bilinear texture sampler (plain
   PyTorch, no kernel) on one textured 1080p G-buffer's lookups against
   the CPU, with its time;
4. goldens: tests/goldens/cube_hybrid_128.png, cornell_full_128.png,
   cube_forward_64.png, cube_raytraced_128.png, stress_textured_128.png,
   cutout_hybrid_128.png and textured_gltf_96.png (tests/goldens/
   textured_tri.glb through the loader) rendered on the card, held to
   the goldens off triangle edges;
5. renders, each of 8 frames on the stress scene (250 objects) at
   1920x1080 from bench.py's camera, with the launch count of every
   kernel it runs (counts set to 0 just before it) and a check that
   no plain version ran on the card:
   a. the headline, bench.py's hybrid frame (shadow + AO + SVGF);
   b. the full graph, the headline plus reflections and diffuse GI;
   c. forward + TAA (LIGHT | IBL | TAA);
   d. the ray-traced path (LIGHT | IBL | EMISSIVE | TAA, the golden's
      flags): depth prepass (K1 vis-only), primary rays (K2c) with their
      sun occlusion (K2), TAA (K5);
   e. the ray-traced path with raster_eval="v2" and
      trace_backend="pallas": K1v, the packet traversal K2b, K5;
   f. the dynamic scene (bench.py's dynamic rung): the headline frame
      with entity 0 turned by rot_y(0.05 k) before frame k through
      DynamicScene.set_entity_transform and commit() (transform update +
      refit, timed apart from the frame), on a fresh scene each run:
      with the default traversal (K2 over the refit binary tree), with
      trace_backend="pallas-wide" and wide_kernel="compressed" (K2w over
      the refit 8-wide tree) and with wide_kernel="mimt" (K2m);
   g. the ray-traced path (d) with wide_kernel "compressed" and "mimt":
      K2w / K2m in both modes (primary rays and their sun occlusion);
   h. textured and cut-out content: H-tex and F-tex, the headline (a)
      and the full graph (b) on the stress scene with four 1024^2 colour
      textures (bench.py's headline_tex1024_ms rung), each also as its
      device ms and operations over (a) and (b); C, the cut-out scene on
      the hybrid path from its golden's camera (K1 twice a frame, the
      opaque and the cut-out layer; the shadow and AO rays' alpha rounds
      through K2c); RC, the cut-out scene on the ray-traced path (the
      primary rays' alpha re-traces and their sun occlusion through
      K2c).
   variance_blur is checked in phase 3 but launched by no path: its
   output feeds nothing (ops/svgf.py).

The last three lines of standard output are the kernels' JSON record,
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Float32 throughout; TF32 is off for
matmul and cuDNN. The rendered images are written to DIR (default: the
system temporary directory).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HEADLINE = dict(width=1920, height=1080, objects=250, frames=8)
# bench.py:113
HEADLINE_CAM = dict(distance=30.0, pitch=0.5, yaw=0.8, focal_point=(0, 2.0, 0))
# tests/test_golden_ladder.py CUBE_CAM
GOLDEN_CAM = dict(distance=7.0, pitch=0.45, yaw=0.6, focal_point=(0, 0.7, 0))
# The golden gate of bench.py (off triangle edges) at the threshold the
# reference meets against itself: its jit and eager renders of the cube
# case differ by ~20 u8 off edges, p99 ~6 (SVGF's variance at shadow
# edges comes from the cancellation m2 - m1^2 and steers its
# edge-stopping weights; tests/torch_gate_reading.py prints the reading,
# and tests/test_torch_slice.py holds the frame before SVGF to 2 u8)
GOLDEN_OFF_EDGE_MAX = 24
GOLDEN_P99_MAX = 8
# tests/test_golden_ladder.py CORNELL_CAM
CORNELL_CAM = dict(distance=13.0, pitch=0.0, yaw=0.0, focal_point=(0, 2.5, 0))
# the full-graph golden's gate: the reference's own jit-vs-eager reading
# on that case (127 / 31, tests/torch_gate_reading.py cornell_full_128)
# plus the margin above; tests/test_torch_full_graph.py holds the same
FULL_GOLDEN_OFF_EDGE_MAX = 131
FULL_GOLDEN_P99_MAX = 33
# the forward and ray-traced goldens' gate, bench.py's
FORWARD_GOLDEN_OFF_EDGE_MAX = 16
FORWARD_GOLDEN_P99_MAX = 2
# the ray-traced path's flags, as its golden (tests/test_golden_ladder.py)
RAYTRACED_FLAGS = ("LIGHT", "IBL", "EMISSIVE", "TAA")
# the textured headline (bench.py's headline_tex1024_ms rung): the stress
# scene with its four procedural colour textures at 1024^2
TEX_SIZE = 1024
# tests/test_golden_ladder.py: the textured golden's camera and the cut-out
# golden's, which the cut-out paths C and RC take at 1080p too
STRESS_GOLDEN_CAM = dict(distance=18.0, pitch=0.5, yaw=0.8,
                         focal_point=(0, 2.0, 0))
CUTOUT_CAM = dict(distance=9.0, pitch=0.35, yaw=0.4, focal_point=(0, 1.2, 0))
GLTF_CAM = dict(distance=4.0, pitch=0.3, yaw=0.2)
# the textured and cut-out goldens' gates: the reference's own jit-vs-eager
# reading on each (79 / 17 and 24 / 6, tests/torch_gate_reading.py) plus
# 4 / 2; tests/test_torch_textured_frames.py holds the same
TEXTURED_GOLDEN_GATE = (83, 19.0)
CUTOUT_GOLDEN_GATE = (28, 8.0)
# the bilinear sampler on the card against the CPU: PyTorch's elementwise
# kernels may contract a multiply-add on the card (tests/test_torch_cuda.py)
SAMPLER_TOL = 1e-6
# the least time the card could take: bytes over the HBM rate, float32
# operations over the rate outside the tensor cores (NVIDIA's H100 SXM
# data sheet, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops):
    """(ms, "bytes" or "operations"): the larger of the two times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cuda_time(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def phase_environment():
    import torch

    from hybridrenderer_tpu_torch import native

    nvcc = subprocess.run([native.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} | nvcc: {nvcc} | card: "
        f"{nvidia_smi_line()} | devices {torch.cuda.device_count()}")


def phase_build():
    from hybridrenderer_tpu_torch import native

    t0 = time.perf_counter()
    native.kernel_library()
    t1 = time.perf_counter()
    native.bvh_library()
    native.obj_library()
    t2 = time.perf_counter()
    log(f"[build] kernels {t1 - t0:.1f} s, bvh and OBJ tokenizer "
        f"{t2 - t1:.1f} s")
    with open(native.kernel_library_path() + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("[build] " + line.strip())
    for name, counts in sass_counts(native.kernel_library_path()).items():
        log(f"[build] SASS of {name}: {counts}")


# what the SVGF stencils' per-tap arithmetic costs beyond its ~30 FLOP:
# IEEE divisions (each checked by an FCHK), the accurate expf and powf
# (built on MUFU.EX2 and MUFU.RCP) and the slow paths they call; and the
# traversals' loads: global (LDG) and of the local stack (LDL, STL)
SASS_OPS = ("FCHK", "MUFU.EX2", "MUFU.RCP", "MUFU.RSQ", "CALL", "LDG", "LDL",
            "STL")
SASS_KERNELS = ("atrous_kernel", "filter_moments_kernel", "trace_any_kernel",
                "trace_closest_kernel", "trace_packet_kernel")


def sass_counts(lib_path, kernels=SASS_KERNELS):
    """Static SASS instruction counts of ``kernels`` in the built
    library, from cuobjdump -sass: {kernel: {"all": n, op: n, ...}};
    empty where the toolkit has no cuobjdump."""
    from hybridrenderer_tpu_torch import native

    tool = os.path.join(os.path.dirname(native.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        log("[build] no cuobjdump: SASS counts not measured")
        return {}
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = next((k for k in kernels if k in line), None)
            if cur is not None:
                counts[cur] = dict.fromkeys(("all",) + SASS_OPS, 0)
            continue
        # an instruction: /*addr*/ [@predicate] OPCODE ...
        parts = line.split("*/", 1)
        if cur is None or len(parts) < 2 or not parts[1].strip():
            continue
        words = parts[1].split()
        op = words[1] if words[0].startswith("@") else words[0]
        if not op[0].isalpha():
            continue
        counts[cur]["all"] += 1
        for k in SASS_OPS:
            if op.startswith(k):
                counts[cur][k] += 1
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _headline_scene(dev, objects):
    from hybridrenderer_tpu_torch.scene import scene as scenes

    return scenes.stress_scene(num_objects=objects).build(dev)


def _clipped(data, width, height, cam_kw):
    """The G-buffer pass's clip for one unjittered camera."""
    import torch

    from hybridrenderer_tpu_torch.core import maths
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import raster

    cam = OrbitCamera(width=width, height=height, **cam_kw).step().to(
        data.device)
    vp = cam.proj @ cam.view
    culled = maths.aabb_outside_frustum(
        data.instances.aabb_min, data.instances.aabb_max,
        maths.frustum_from_viewproj(vp))
    soup = data.triangles
    corners = torch.stack([raster.transform_to_clip(v, vp)
                           for v in (soup.v0, soup.v1, soup.v2)], dim=1)
    return raster.clip_triangles(corners, width, height,
                                 ~culled[soup.instance.long()],
                                 soup.single_sided)


def _raster_exact(args):
    """K1 and its plain version on ``args`` → (max err, the kernel's
    VisibilityBuffer and attributes); raises unless they are equal."""
    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    W, H = args[-2:]
    vk, ak = rc.raster_tiles(*args)
    vp, ap = rc.raster_tiles_plain(*args)
    same = vk.tri_id == vp.tri_id
    mismatch = 1.0 - same.float().mean().item()
    err = max((a - b).abs()[same].max().item() for a, b in (
        (vk.depth, vp.depth), (vk.bary1, vp.bary1), (vk.bary2, vp.bary2),
        (ak, ap)))
    # same float operations in the same order (-fmad=false): exact
    if mismatch > 0.0 or err > 0.0:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{W}x{H}: {mismatch:.2e} of pixels, max err "
                             f"{err}")
    return err, vk, ak


def check_raster(dev):
    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    rec, bbox, valid = rc.pack_candidates(_clipped(data, W, H, HEADLINE_CAM))
    ts, ec = rc.bin_candidates(bbox, valid, W, H)
    args = (rec, ts, ec, data.raster_rows, W, H)
    err, vk, ak = _raster_exact(args)
    # an odd size: tiles cut in both axes, and tiles that list more than
    # 256 candidates, so the kernel walks several staged chunks
    Wo, Ho = 203, 117
    rec_o, bbox_o, valid_o = rc.pack_candidates(
        _clipped(data, Wo, Ho, HEADLINE_CAM))
    ts_o, ec_o = rc.bin_candidates(bbox_o, valid_o, Wo, Ho)
    err = max(err, _raster_exact((rec_o, ts_o, ec_o, data.raster_rows, Wo,
                                  Ho))[0])
    most_o = int((ts_o[1:] - ts_o[:-1]).max())
    ms = cuda_time(lambda: rc.raster_tiles(*args), 20)
    plain_ms = cuda_time(lambda: rc.raster_tiles_plain(*args), 2)
    # ~20 FLOP per (candidate, pixel) coverage test, every pixel of the
    # 16x16 tile of every tile entry (csrc/raster.cu)
    b = bound(nbytes(rec, ts, ec, data.raster_rows, vk.tri_id, vk.depth,
                     vk.bary1, vk.bary2, ak),
              20.0 * ec.shape[0] * rc.TILE * rc.TILE)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound=b,
                shape=f"{W}x{H}, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates; exact too at {Wo}x{Ho} "
                      f"({ec_o.shape[0]} tile entries, up to {most_o} in a "
                      f"tile)",
                tol="exact (tri ids and all outputs), at both sizes")


def check_trace(dev):
    """K2 on the rays of one headline frame: RTShadowPass's shadow query
    (tmax 10000) and AO query (tmax 10), 2 x 1920*1080 rays, recorded as
    the renderer hands them to the tracer."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import trace_cuda
    from hybridrenderer_tpu_torch.ops.trace import TMIN
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_hybrid_settings(W, H), data)
    tracer, query, batches = r.tracer, r.tracer.shadow_query, []

    def recording_query(*a, **kw):
        batches.append(tracer.shadow_rays(*a, **kw))
        return query(*a, **kw)

    tracer.shadow_query = recording_query
    r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
        taa_enabled=True))
    del tracer.shadow_query
    if len(batches) != 2 or any(o.shape[0] != W * H for o, *_ in batches):
        raise AssertionError(f"expected the shadow and AO queries of "
                             f"{W}x{H} rays, got "
                             f"{[o.shape[0] for o, *_ in batches]}")
    # image queries: the kernel traces them in 8x4 tiles, as on the path
    kern = lambda: [trace_cuda.intersect_any(tracer.packed, o, d, TMIN, t, a,
                                             W)
                    for o, d, t, a in batches]
    plain = lambda: [trace_cuda.intersect_any_plain(tracer.packed, o, d, TMIN,
                                                    t, a)
                     for o, d, t, a in batches]
    visits = {}
    tks = kern()
    tps = [trace_cuda.intersect_any_plain(tracer.packed, o, d, TMIN, t, a,
                                          visits=visits)
           for o, d, t, a in batches]
    mismatch, hit, tri_diff = [], [], []
    for (o, d, t, a), tk, tp in zip(batches, tks, tps):
        mismatch.append(((tk >= 0) != (tp >= 0)).float().mean().item())
        hit.append((tp >= 0)[a].float().mean().item())
        tri_diff.append(int((tk != tp).sum()))
    # both take the same path through the tree with the same arithmetic,
    # so even the reported triangle agrees; 0.1% slack on visibility for
    # grazing rays, none on the triangle
    if max(mismatch) > 1e-3 or max(tri_diff) > 0:
        raise AssertionError(f"K2 disagrees with its plain version (shadow, "
                             f"AO): visibility mismatch {mismatch}, rays "
                             f"whose triangle differs {tri_diff}")
    depth = tracer.packed.depth
    R = batches[0][0].shape[0]
    active = [int(a.sum()) for *_, a in batches]
    return dict(err=max(mismatch), ms=cuda_time(kern, 20),
                plain_ms=cuda_time(plain, 1),
                bound=trace_bound(_tree(tracer.packed), batches, tks, visits),
                shape=f"2 queries (shadow tmax 10000, AO tmax 10) of {R} rays "
                      f"of one {W}x{H} headline frame, {active} active, "
                      f"{data.num_triangles} triangles, tree depth {depth}, "
                      f"hit shadow {hit[0]:.3f} AO {hit[1]:.3f}; rays whose "
                      f"triangle differs from the plain version's "
                      f"{tri_diff}; ms for both",
                tol="visibility mismatch <= 1e-3 of rays per query; every "
                    "ray's triangle equal")


def trace_bound(tree, batches, outs, visits):
    """The tree's tensors ``tree`` read once; every ray's active flag
    read and its outputs written once, an active ray's origin, direction
    and tmax read once (an inactive ray needs nothing else); ~30 FLOP
    per child-box slab test (two per internal node visited) and ~40 per
    triangle test, over the binary-tree nodes these rays visit (counted
    by K2's or K2c's plain version)."""
    data = nbytes(*tree)
    for (o, d, tmax, active), out in zip(batches, outs):
        per_active = (o[0], d[0], tmax[:1])
        data += nbytes(active, *(out if isinstance(out, tuple) else (out,)))
        data += int(active.sum()) * nbytes(*per_active)
    return bound(data, 60.0 * visits["internal"] + 40.0 * visits["leaf"])


def _tree(packed):
    return packed.nodes, packed.node_tri, packed.tri_verts


def check_trace_closest(dev):
    """K2c on the rays of one full-graph frame at 1920x1080 on the
    headline camera: RTReflectionPass's reflection rays and
    RTDiffuseGIPass's GI rays, recorded as the passes hand them to the
    tracer."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.ops import trace_cuda
    from hybridrenderer_tpu_torch.ops.trace import RADIANCE_TMIN
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_hybrid_settings(
        W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI), data)
    tracer, trace, batches = r.tracer, r.tracer.trace_radiance, []

    def recording(scene, origin, direction, ctx, depth=0, active=None):
        batches.append(tracer.radiance_rays(origin, direction, active))
        return trace(scene, origin, direction, ctx, depth, active=active)

    tracer.trace_radiance = recording
    r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
        taa_enabled=True))
    del tracer.trace_radiance
    if len(batches) != 2 or any(o.shape[0] != W * H for o, *_ in batches):
        raise AssertionError(f"expected the reflection and GI queries of "
                             f"{W}x{H} rays, got "
                             f"{[o.shape[0] for o, *_ in batches]}")
    kern = lambda: [trace_cuda.intersect_closest(tracer.packed, o, d,
                                                 RADIANCE_TMIN, t, a, W)
                    for o, d, t, a in batches]
    plain = lambda: [trace_cuda.intersect_closest_plain(
        tracer.packed, o, d, RADIANCE_TMIN, t, a) for o, d, t, a in batches]
    visits = {}
    ks = kern()
    ps = [trace_cuda.intersect_closest_plain(tracer.packed, o, d,
                                             RADIANCE_TMIN, t, a,
                                             visits=visits)
          for o, d, t, a in batches]
    mismatch, errs, hit = [], [0.0, 0.0, 0.0], []
    for (o, d, t, a), k, p in zip(batches, ks, ps):
        same = k[1] == p[1]
        mismatch.append((~same & a).float().sum().item()
                        / max(int(a.sum()), 1))
        both = same & (p[1] >= 0)
        for i, c in enumerate((0, 2, 3)):
            if bool(both.any()):
                errs[i] = max(errs[i],
                              (k[c] - p[c]).abs()[both].max().item())
        hit.append((p[1] >= 0)[a].float().mean().item())
    # the same path through the tree with the same arithmetic
    # (-fmad=false): exact; 0.1% slack on the triangle for grazing rays,
    # none on t, u and v where the triangle agrees
    if max(mismatch) > 1e-3 or max(errs) > 0.0:
        raise AssertionError(f"K2c disagrees with its plain version "
                             f"(reflection, GI): triangle mismatch "
                             f"{mismatch}, max err t, u, v {errs}")
    active = [int(a.sum()) for *_, a in batches]
    return dict(err=max(errs), ms=cuda_time(kern, 10),
                plain_ms=cuda_time(plain, 1),
                bound=trace_bound(_tree(tracer.packed), batches, ks, visits),
                shape=f"2 queries (reflection, GI; tmax 1e6) of "
                      f"{batches[0][0].shape[0]} rays of one {W}x{H} "
                      f"full-graph frame, {active} active, hit "
                      f"{hit[0]:.3f} / {hit[1]:.3f} of the active; max "
                      f"err t {errs[0]:.3g} u {errs[1]:.3g} v {errs[2]:.3g};"
                      f" triangle mismatch {mismatch}; ms for both",
                tol="triangle mismatch <= 1e-3 of active rays per query; "
                    "t, u, v exact where the triangle agrees")


def _raytraced_settings(width, height, **kw):
    """The ray-traced path with the golden's flags."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType

    flags = RenderFlags(0)
    for f in RAYTRACED_FLAGS:
        flags |= RenderFlags[f]
    return RenderSettings(width=width, height=height,
                          path=RenderPathType.RAYTRACED, flags=flags, **kw)


def packet_frame(dev):
    """One 1920x1080 frame of the ray-traced path with raster_eval "v2"
    and trace_backend "pallas" on the headline camera, recording what
    the depth prepass hands K1v (bins of the jittered clip) and what the
    tracer hands K2b: the primary rays (closest-hit) and their
    sun-occlusion rays (any-hit), in pixel order with the image width,
    which K2b traces in 8x4 tile packets; and how often the frame called
    torch.argsort (no relayout of the rays needs one)."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import raster_cuda, trace
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_raytraced_settings(W, H, raster_eval="v2",
                                               trace_backend="pallas"), data)
    vis_calls, ray_calls, sorts = [], [], []
    vis, packet, argsort = (raster_cuda.raster_tiles, trace.intersect_packet,
                            torch.argsort)

    def recording_vis(*a, **kw):
        if kw.get("keyed"):
            vis_calls.append(a)
        return vis(*a, **kw)

    def recording_packet(*a, **kw):
        ray_calls.append((a, kw))
        return packet(*a, **kw)

    def counting_argsort(*a, **kw):
        sorts.append(1)
        return argsort(*a, **kw)

    raster_cuda.raster_tiles, trace.intersect_packet = recording_vis, \
        recording_packet
    torch.argsort = counting_argsort
    try:
        r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
            taa_enabled=True))
    finally:
        raster_cuda.raster_tiles, trace.intersect_packet = vis, packet
        torch.argsort = argsort
    if len(vis_calls) != 1 or len(ray_calls) != 2:
        raise AssertionError(f"expected one K1v call and two K2b queries, "
                             f"got {len(vis_calls)} and {len(ray_calls)}")
    return dict(tracer=r.tracer, vis=vis_calls[0], rays=ray_calls,
                data=data, triangles=data.num_triangles, argsorts=len(sorts))


def check_packet_path(dev):
    """K1v and K2b on the inputs of one ray-traced packet frame."""
    frame = packet_frame(dev)
    return {"raster_vis": check_raster_vis(frame),
            "trace_packet": check_trace_packet(frame)}


def _vis_mismatch(name, k, p):
    """Raise unless VisibilityBuffers ``k`` and ``p`` are equal; → the
    largest difference (0.0)."""
    mismatch = (k.tri_id != p.tri_id).sum().item()
    err = max((a - b).abs().max().item() for a, b in (
        (k.depth, p.depth), (k.bary1, p.bary1), (k.bary2, p.bary2)))
    # same float operations in the same order (-fmad=false): exact
    if mismatch or err > 0.0:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{mismatch} pixels, max err {err}")
    return err


def check_raster_vis(frame):
    """K1v, and K1 vis-only (the default depth prepass), on the 1080p
    ray-traced depth prepass's bins and on a 203x117 prepass of the same
    camera, each against its plain version; the 1080p bins' entry counts
    a tile, and both kernels timed on a launch that holds only the
    heaviest tile's list (the other tiles empty)."""
    import torch

    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    def exact(args, where):
        k, _ = rc.raster_tiles(*args, keyed=True)
        err = _vis_mismatch(f"K1v ({where})", k, rc.raster_vis_plain(
            *args[:3], *args[4:]))
        k1, _ = rc.raster_tiles(*args)
        _vis_mismatch(f"K1 vis-only ({where})", k1,
                      rc.raster_tiles_plain(*args)[0])
        return err, k, k1

    rec, ts, ec, _, W, H = frame["vis"]
    args = (rec, ts, ec, None, W, H)
    err, k, k1 = exact(args, f"{W}x{H}")
    Wo, Ho = 203, 117
    rec_o, bbox_o, valid_o = rc.pack_candidates(
        _clipped(frame["data"], Wo, Ho, HEADLINE_CAM))
    ts_o, ec_o = rc.bin_candidates(bbox_o, valid_o, Wo, Ho)
    exact((rec_o, ts_o, ec_o, None, Wo, Ho), f"{Wo}x{Ho}")
    most_o = int((ts_o[1:] - ts_o[:-1]).max())
    # entries a tile, and the heaviest tile's list alone
    counts = (ts[1:] - ts[:-1]).long()
    heavy = int(counts.argmax())
    ts_h = torch.zeros_like(ts)
    ts_h[heavy + 1:] = int(counts[heavy])
    ec_h = ec[int(ts[heavy]):int(ts[heavy + 1])].contiguous()
    heavy_args = (rec, ts_h, ec_h, None, W, H)
    exact(heavy_args, "heaviest tile alone")
    hist = (f"entries a tile: max {int(counts.max())} (tile {heavy}), p99 "
            f"{float(torch.quantile(counts.float(), 0.99)):.0f}, mean "
            f"{float(counts.float().mean()):.2f}, {int((counts > 0).sum())} "
            f"of {counts.numel()} tiles non-empty, "
            f"{int((counts > rc.GROUP).sum())} over {rc.GROUP}, "
            f"{int((counts > 1024).sum())} over 1024")
    ties = (k1.tri_id != k.tri_id).float().mean().item()
    ms = cuda_time(lambda: rc.raster_tiles(*args, keyed=True), 20)
    k1_ms = cuda_time(lambda: rc.raster_tiles(*args), 20)
    heavy_ms = cuda_time(lambda: rc.raster_tiles(*heavy_args, keyed=True),
                         20)
    heavy_k1_ms = cuda_time(lambda: rc.raster_tiles(*heavy_args), 20)
    log(f"[kernel] raster_vis bins: {hist}; the heaviest tile alone K1v "
        f"{heavy_ms:.4f} ms, K1 vis-only {heavy_k1_ms:.4f} ms; all tiles "
        f"K1v {ms:.4f} ms, K1 vis-only {k1_ms:.4f} ms")
    # K1's ~20 FLOP per (candidate, pixel) coverage test and key; the
    # same bound holds K1 vis-only on these bins
    b = bound(nbytes(rec, ts, ec, k.tri_id, k.depth, k.bary1, k.bary2),
              20.0 * ec.shape[0] * rc.TILE * rc.TILE)
    return dict(err=err, ms=ms, plain_ms=cuda_time(
                    lambda: rc.raster_vis_plain(rec, ts, ec, W, H), 2),
                bound=b,
                shape=f"{W}x{H} depth prepass, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates ({hist}); the heaviest "
                      f"tile alone {heavy_ms:.4f} ms; K1 vis-only on the "
                      f"same bins {k1_ms:.4f} ms (bound {b[0]:.4f} ms too; "
                      f"heaviest tile alone {heavy_k1_ms:.4f} ms), winner "
                      f"differs from K1's on {ties:.2e} of pixels (2^-17 "
                      f"near-ties); both exact too at {Wo}x{Ho} "
                      f"({ec_o.shape[0]} tile entries, up to {most_o} in a "
                      f"tile) and on the heaviest tile alone",
                tol="exact (tri ids and all outputs), K1 vis-only too, at "
                    "both sizes")


def check_trace_packet(frame):
    """K2b on the ray-traced packet frame's two queries, each against
    its plain version (exact: the same packets take the same path with
    the same arithmetic), then against the per-ray K2c (primary rays)
    and K2 (occlusion rays) on the same rays in the same order."""
    from hybridrenderer_tpu_torch.ops import trace_cuda as tc

    W, H = HEADLINE["width"], HEADLINE["height"]
    packed = frame["tracer"].packed
    # (o, d, tmin, tmax, active) and the mode of each recorded query
    queries = [a[1:6] for a, _ in frame["rays"]]
    modes = [a[6] for a, _ in frame["rays"]]
    widths = [a[7] for a, _ in frame["rays"]]
    if modes != [False, True] or widths != [W, W] or frame["argsorts"]:
        raise AssertionError(f"expected closest-hit then any-hit, each "
                             f"with width {W}, and no argsort: {modes}, "
                             f"{widths}, {frame['argsorts']} argsorts")
    kern = lambda: [tc.intersect_packet(packed, *q, m, W)
                    for q, m in zip(queries, modes)]
    plain = lambda visits=None: [
        tc.intersect_packet_plain(packed, *q, m, W, visits=visits)
        for q, m in zip(queries, modes)]
    packet_visits = {}
    ks, ps = kern(), plain(packet_visits)
    errs = [0.0, 0.0, 0.0]   # t, u, v over both queries, where p hits
    for k, p in zip(ks, ps):
        if bool((k[1] != p[1]).any()):
            raise AssertionError(f"K2b triangle mismatch: "
                                 f"{(k[1] != p[1]).sum().item()} rays")
        hit = p[1] >= 0
        if bool(hit.any()):
            for i, c in enumerate((0, 2, 3)):
                errs[i] = max(errs[i],
                              (k[c] - p[c]).abs()[hit].max().item())
    if max(errs) > 0.0:
        raise AssertionError(f"K2b differs from the plain version: max err "
                             f"t, u, v {errs}")
    # the per-ray kernels on the same rays over the same records, in 8x4
    # tiles a warp as the ray-traced path traces them; the bound counts
    # the nodes and triangles the per-ray plain versions visit, as for K2
    # and K2c
    (o, d, tmin, tmax, act), (o2, d2, tmin2, tmax2, act2) = queries
    closest = lambda: tc.intersect_closest(packed, o, d, tmin, tmax, act, W)
    anyhit = lambda: tc.intersect_any(packed, o2, d2, tmin2, tmax2, act2, W)
    c, a = closest(), anyhit()
    visits = {}
    tc.intersect_closest_plain(packed, o, d, tmin, tmax, act, visits=visits)
    tc.intersect_any_plain(packed, o2, d2, tmin2, tmax2, act2, visits=visits)
    flips = ((a >= 0) != (ks[1][1] >= 0)).sum().item()
    t_diff = (c[0] - ks[0][0]).abs().nan_to_num().max().item()
    if flips or t_diff > 0.0:
        raise AssertionError(f"K2b against K2 / K2c: {flips} visibility "
                             f"flips, closest t differs by {t_diff}")
    tri_diff = ((c[1] != ks[0][1]) & act).sum().item()
    times = [cuda_time(lambda q=q, m=m: tc.intersect_packet(
        packed, *q, m, W), 10) for q, m in zip(queries, modes)]
    per_ray_ms = cuda_time(closest, 10), cuda_time(anyhit, 10)
    active = [int(q[4].sum()) for q in queries]
    hit = [(p[1] >= 0)[q[4]].float().mean().item()
           for p, q in zip(ps, queries)]
    return dict(err=max(errs), ms=sum(times), plain_ms=cuda_time(plain, 1),
                bound=trace_bound(_tree(packed), [(q[0], q[1], q[3], q[4])
                                           for q in queries],
                                  [ks[0], ks[1][1]], visits),
                shape=f"primary rays (closest-hit, tmax 1e6) and their sun "
                      f"occlusion rays (any-hit, tmax 1000) of one {W}x{H} "
                      f"ray-traced frame, {queries[0][0].shape[0]} rays "
                      f"each, {active} active, hit {hit[0]:.3f} / "
                      f"{hit[1]:.3f}, {frame['triangles']} triangles; K2b "
                      f"{times[0]:.4f} + {times[1]:.4f} ms with width {W} "
                      f"and no argsort in the frame (max err t "
                      f"{errs[0]:.3g} u {errs[1]:.3g} v {errs[2]:.3g}) vs "
                      f"per-ray K2c "
                      f"{per_ray_ms[0]:.4f} ms and K2 {per_ray_ms[1]:.4f} ms "
                      f"on the same rays (closest t equal, {tri_diff} "
                      f"equal-t triangle ties, no visibility flip); nodes "
                      f"visited by packets {packet_visits} (one a step) vs "
                      f"by rays {visits}; build {tc.packet_kernel_info()}; "
                      f"ms for both",
                tol="exact (tri, t, u, v)")


def wide_queries(dev):
    """What SceneTracer hands the wide kernels on the 1080p paths, with
    trace_backend "pallas-wide" and wide_kernel "compressed": the
    headline frame's shadow and AO queries (any-hit, 32x32 tile-major
    rays) and the ray-traced frame's primary rays (closest-hit) and
    their sun occlusion rays (any-hit); → (queries (name, o, d, tmin,
    tmax, active, any_hit), the wide records, the scene)."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import trace
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    calls, real = [], trace.intersect_wide

    def recording(wide, *args):
        calls.append(args)
        return real(wide, *args)

    kw = dict(trace_backend="pallas-wide", wide_kernel="compressed")
    trace.intersect_wide = recording
    try:
        tracers = []
        for settings in (_hybrid_settings(W, H, **kw),
                         _raytraced_settings(W, H, **kw)):
            r = Renderer.for_scene(settings, data)
            r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
                taa_enabled=True))
            tracers.append(r.tracer)
    finally:
        trace.intersect_wide = real
    names = ["shadow", "AO", "primary", "occlusion"]
    if [c[-1] for c in calls] != [True, True, False, True]:
        raise AssertionError(f"expected the {names} queries, got modes "
                             f"{[c[-1] for c in calls]}")
    return ([(n, *c) for n, c in zip(names, calls)], tracers[0].wide,
            data)


def torch_equal_nan(a, b):
    """Whether two result tensors are equal, NaN where NaN."""
    import torch

    return torch.equal(a, b) or bool(((a == b) | (torch.isnan(a)
                                                 & torch.isnan(b))).all())


def abs_diff_nan(a, b) -> float:
    """max |a - b|, 0 where both are NaN or equal (both +inf on a miss),
    inf where only one is NaN."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if bool(same.all()):
        return 0.0
    inf = float("inf")
    return (a - b).abs().nan_to_num(nan=inf, posinf=inf)[~same].max().item()


# float operations of one slab test and one Moller-Trumbore test
# (csrc/trace.cu wide_slab, wide_leaf)
SLAB_FLOP, TRIANGLE_FLOP = 25, 54


def check_wide(dev):
    """K2w and K2m on the four wide queries of the 1080p paths (all rays),
    each exact against its plain version (t, tri, u, v apart), then
    against the per-ray K2 (any-hit) and K2c (closest-hit) over the
    binary tree on the same rays: no visibility flip, closest t equal.
    Beside each kernel's time: the plain version's step counters, the
    contract's own tests (every pop against every ray of its packet or
    row) as FLOP at the fp32 peak, and the build's registers, local
    memory (stack frame and spills) and blocks an SM."""
    from hybridrenderer_tpu_torch.ops import trace_cuda as tc
    from hybridrenderer_tpu_torch.ops.trace import SceneTracer

    queries, wide, data = wide_queries(dev)
    packed = SceneTracer.build(data).packed
    rays = [q[1:6] for q in queries]        # o, d, tmin, tmax, active
    modes = [q[6] for q in queries]
    # the per-ray kernels and their visits on the same rays (the bound)
    per_ray = [(lambda r=r, m=m: tc.intersect_any(packed, *r) if m
                else tc.intersect_closest(packed, *r))
               for r, m in zip(rays, modes)]
    ref = [f() for f in per_ray]
    visits = {}
    for r, m in zip(rays, modes):
        (tc.intersect_any_plain if m else tc.intersect_closest_plain)(
            packed, *r, visits=visits)
    per_ray_ms = [cuda_time(f, 5) for f in per_ray]
    W, H = HEADLINE["width"], HEADLINE["height"]
    out = {}
    for name, kern, plain in (
            ("trace_wide", tc.intersect_wide, tc.intersect_wide_plain),
            ("trace_mimt", tc.intersect_mimt, tc.intersect_mimt_plain)):
        deep0 = int(wide.deep_pushes.item())
        ks = [kern(wide, *r, m) for r, m in zip(rays, modes)]
        deep = int(wide.deep_pushes.item()) - deep0
        steps = {}
        ps = [plain(wide, *r, m, visits=steps) for r, m in zip(rays, modes)]
        # the plain version counts its deep pushes on the same counter
        plain_deep = int(wide.deep_pushes.item()) - deep0 - deep
        if deep != plain_deep:
            raise AssertionError(f"{name}: {deep} leaf pushes past 128 "
                                 f"entries, the plain version {plain_deep}")
        err, tri_bad = 0.0, 0   # max |kernel - plain| over t, u, v
        for (qn, *_), k, p in zip(queries, ks, ps):
            bad = [f for f, a, b in zip("t tri u v".split(), k, p)
                   if not torch_equal_nan(a, b)]
            tri_bad += int((k[1] != p[1]).sum())
            err = max([err] + [abs_diff_nan(k[c], p[c]) for c in (0, 2, 3)])
            if bad:
                raise AssertionError(f"{name} differs from its plain "
                                     f"version on the {qn} rays in {bad}: "
                                     f"max err t, u, v {err}, {tri_bad} "
                                     f"triangles")
        flips, t_diff, ties = 0, 0.0, 0
        for r, m, k, ref_out in zip(rays, modes, ks, ref):
            act = r[4]
            tri = k[1].clone()
            tri[tri == tc.INACTIVE_TRI] = -1
            ref_tri = ref_out if m else ref_out[1]
            flips += int(((tri >= 0) != (ref_tri >= 0))[act].sum())
            if not m:
                hit = (ref_tri >= 0) & act
                t_diff = max(t_diff, (k[0] - ref_out[0]).abs()[hit].max()
                             .item())
                ties += int(((tri != ref_tri) & hit).sum())
        total = sum(int(r[4].sum()) for r in rays)
        if flips > 1e-3 * total or t_diff > 1e-4:
            raise AssertionError(f"{name} against K2 / K2c: {flips} "
                                 f"visibility flips of {total} active rays, "
                                 f"closest t differs by {t_diff}")
        times = [cuda_time(lambda r=r, m=m: kern(wide, *r, m), 5)
                 for r, m in zip(rays, modes)]
        plain_ms = cuda_time(lambda: [plain(wide, *r, m)
                                      for r, m in zip(rays, modes)], 1)
        b = trace_bound((wide.nodes_flat, wide.leaves_flat, wide.meta),
                        [(r[0], r[1], r[3], r[4]) for r in rays],
                        [k if not m else k[1] for k, m in zip(ks, modes)],
                        visits)
        active = [int(r[4].sum()) for r in rays]
        mimt = name == "trace_mimt"
        unit = "row" if mimt else "packet"
        rays_per_unit = tc.WIDE_PACKET // (tc.WIDE_ROWS if mimt else 1)
        contract = rays_per_unit * (8 * SLAB_FLOP * steps["internal"]
                                    + 4 * TRIANGLE_FLOP * steps["leaf"])
        info = tc.wide_kernel_info(mimt)
        out[name] = dict(
            err=err, ms=sum(times), plain_ms=plain_ms, bound=b,
            shape=f"the shadow, AO (any-hit) and primary (closest-hit) rays "
                  f"of one {W}x{H} headline / ray-traced frame in 32x32 "
                  f"tile order and the primary hits' sun occlusion rays "
                  f"(any-hit), {[r[0].shape[0] for r in rays]} rays, "
                  f"{active} active, {data.num_triangles} triangles, wide "
                  f"tree of {wide.num_wide} nodes, {wide.num_clusters} "
                  f"clusters, depth {wide.depth}; "
                  + " + ".join(f"{t:.4f}" for t in times)
                  + f" ms vs per-ray K2 / K2c "
                  + " + ".join(f"{t:.4f}" for t in per_ray_ms)
                  + f" ms on the same rays ({flips} visibility flips, "
                  f"closest t within {t_diff:.3g}, {ties} equal-t triangle "
                  f"ties; {tri_bad} triangles differ from the plain "
                  f"version's); {unit} pops {steps['internal']} nodes, "
                  f"{steps['leaf']} clusters in {steps['steps']} program "
                  f"steps, {steps['idle_internal']} / {steps['idle_leaf']} "
                  f"{unit} steps popping no node / no cluster; contract "
                  f"tests {contract / 1e9:.2f} GFLOP = "
                  f"{contract / FP32_FLOPS_PER_S * 1e3:.4f} ms at the fp32 "
                  f"peak; per-ray node visits {visits}; {deep} leaf pushes "
                  f"past the reference's 128 entries; build {info}; ms for "
                  f"all four",
            tol="exact (t, tri, u, v)")
    return out


def _frame_planes(dev, H, W, seed):
    """Seeded G-buffer-like planes at (H, W): a ground of smooth depth
    with ~10% background, a few object ids, unit normals near +y."""
    import torch

    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 5.0 + 20.0 * yy / H + 0.2 * g.random((H, W)).astype(np.float32)
    oid = ((xx // 97 + yy // 61) % 7).astype(np.int32)
    bg = g.random((H, W)) < 0.1
    depth[bg] = 0.0
    oid[bg] = -1
    nrm = np.stack([0.1 * g.standard_normal((H, W)), np.ones((H, W)),
                    0.1 * g.standard_normal((H, W))], -1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    motion = np.zeros((H, W, 4), np.float32)
    motion[..., 0] = 0.003 * np.sin(yy / 50.0)
    motion[..., 1] = -0.002
    motion[..., 2] = depth
    motion[..., 3] = 0.05 * g.random((H, W))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return t(depth), t(oid), t(nrm), t(motion), g


def check_temporal(dev):
    import torch

    from hybridrenderer_tpu_torch.ops import temporal_cuda

    H, W = HEADLINE["height"], HEADLINE["width"]
    depth, oid, nrm, mp, g = _frame_planes(dev, H, W, 1)
    hist_sig = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    hist_mom = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    prev_depth = (depth * 1.01).contiguous()
    args = (hist_sig, hist_mom, nrm, prev_depth, oid, mp, nrm, oid)
    k = temporal_cuda.temporal_fetch(*args)
    p = temporal_cuda.temporal_fetch_plain(*args)
    diff = (k - p).abs()
    err = diff.max().item()
    if err > 1e-5:
        y, x, c = np.unravel_index(int(diff.argmax()), diff.shape)
        raise AssertionError(
            f"K3 max err {err} at pixel ({y}, {x}) channel {c}: kernel "
            f"{k[y, x].tolist()} plain {p[y, x].tolist()} motion "
            f"{mp[y, x].tolist()} oid {oid[y, x].item()}")
    valid = (p[..., 7] > 0.01).float().mean().item()
    ms = cuda_time(lambda: temporal_cuda.temporal_fetch(*args), 50)
    plain_ms = cuda_time(lambda: temporal_cuda.temporal_fetch_plain(*args), 5)
    check_reproject(dev, H, W, hist_sig, hist_mom, prev_depth, oid, nrm, mp)
    # ~25 FLOP per tap (validation + 7 weighted sums), 4 taps a pixel
    return dict(err=err, ms=ms, plain_ms=plain_ms,
                bound=bound(nbytes(*args, k), 110.0 * H * W),
                shape=f"{W}x{H}, bf16 history, {valid:.3f} valid",
                tol="1e-5 abs")


def check_reproject(dev, H, W, hist_sig, hist_mom, prev_depth, oid, nrm, mp):
    """K3s: the reference's single-signal entry (legacy (12, H, W) pack)
    over K3 on the card, against the same call on the CPU (plain)."""
    import torch

    from hybridrenderer_tpu_torch.ops import temporal_cuda

    hpack = torch.cat([hist_sig.float().permute(2, 0, 1),
                       hist_mom.float()[..., [0, 1, 3]].permute(2, 0, 1),
                       nrm.permute(2, 0, 1), prev_depth[None],
                       oid.float()[None]]).contiguous()
    args = (hpack, mp[..., :2].contiguous(), nrm, mp[..., 2].contiguous(),
            oid)
    k = temporal_cuda.reproject(*args)
    p = temporal_cuda.reproject(*(a.cpu() for a in args))
    err = max((a.cpu() - b).abs().max().item() for a, b in zip(k, p))
    log(f"[kernel] reproject (K3s over K3): max err {err:.3g} against the "
        f"CPU plain version at {W}x{H} (tol 1e-5 abs)")
    if err > 1e-5:
        raise AssertionError(f"K3s max err {err}")


def check_window_sample(dev):
    """K5 on the TAA history fetch of the forward + TAA frame at
    1920x1080 on the headline camera (the third frame's fetch: a
    three-plane f32 history and its reprojected uv), against its plain
    version and against grid_sample, which computes the same function
    (bilinear, border padding, align_corners=False, uv * 2 - 1)."""
    import torch
    import torch.nn.functional as F

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import taa, temporal_cuda
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_forward_settings(W, H), data)
    calls = []

    def recording(image, uv):
        calls.append((image, uv))
        return temporal_cuda.window_sample(image, uv)

    taa.window_sample = recording
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    try:
        for _ in range(3):
            r.render(cam.step(taa_enabled=True))
            cam.orbit(0.01, 0.0)
    finally:
        taa.window_sample = temporal_cuda.window_sample
    image, uv = calls[-1]
    k = temporal_cuda.window_sample(image, uv)
    p = temporal_cuda.window_sample_plain(image, uv)
    err = (k - p).abs().max().item()
    if err > 0.0:
        raise AssertionError(f"K5 max err {err}")
    grid = (uv * 2.0 - 1.0).unsqueeze(0)
    planes = image.permute(2, 0, 1).unsqueeze(0).contiguous()
    lib = lambda: F.grid_sample(planes, grid, mode="bilinear",
                                padding_mode="border", align_corners=False)
    lib_err = (lib()[0].permute(1, 2, 0) - k).abs().max().item()
    on = ((uv >= 0.0) & (uv <= 1.0)).all(-1).float().mean().item()
    P = image.shape[-1]
    return dict(err=err, ms=cuda_time(lambda: temporal_cuda.window_sample(
                    image, uv), 50),
                plain_ms=cuda_time(lambda: temporal_cuda.window_sample_plain(
                    image, uv), 10),
                library_ms=cuda_time(lib, 50),
                # 4 taps: ~10 FLOP of coordinates, 6 per plane
                bound=bound(nbytes(image, uv, k), (10.0 + 6.0 * P) * H * W),
                shape=f"{W}x{H}, {P} f32 planes (the third forward + TAA "
                      f"frame's history), {on:.4f} of uv on screen; "
                      f"grid_sample differs by {lib_err:.3g}",
                tol="exact")


def _stencil_inputs(dev, H, W, seed):
    """(signal, moments, normal, motion plane) at (H, W), from a seed."""
    import torch

    depth, oid, nrm, mp, g = _frame_planes(dev, H, W, seed)
    sig = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(dev)
    mom = torch.from_numpy((g.random((H, W, 4)) * [1, 1, 1, 8]).astype(
        np.float32)).to(dev)
    return sig, mom, nrm, mp


def check_stencils(dev):
    from hybridrenderer_tpu_torch.ops import stencil_cuda as sc

    H, W = HEADLINE["height"], HEADLINE["width"]
    phi_l, phi_a, phi_n = 4.0, 128.0, float(np.float32(0.02))

    def cases(sig, mom, nrm, mp):
        return {
            "filter_moments": (
                lambda: sc.filter_moments(sig, mom, nrm, mp, phi_l, phi_n),
                lambda: sc.filter_moments_plain(sig, mom, nrm, mp, phi_l,
                                                phi_n)),
            "variance_blur": (lambda: sc.variance_blur(mom),
                              lambda: sc.variance_blur_plain(mom)),
            "atrous": (lambda: [sc.atrous(sig, nrm, mp, s, phi_a, phi_n)
                                for s in (1, 2, 4)],
                       lambda: [sc.atrous_plain(sig, nrm, mp, s, phi_a,
                                                phi_n) for s in (1, 2, 4)]),
        }

    def rel_err(kern, plain):
        ks, ps = kern(), plain()
        ks = ks if isinstance(ks, (list, tuple)) else [ks]
        ps = ps if isinstance(ps, (list, tuple)) else [ps]
        # exp and pow may differ in the last ulp between CUDA and
        # PyTorch; outputs are normalized weighted means and variances
        return ks, max(((a - b).abs() / (1.0 + b.abs())).max().item()
                       for a, b in zip(ks, ps))

    sig, mom, nrm, mp = _stencil_inputs(dev, H, W, 2)
    # odd sizes: 117x203 is not a multiple of the tiles, 5x7 is smaller
    # than atrous' halo at step 4
    odd = {(h, w): cases(*_stencil_inputs(dev, h, w, 3))
           for h, w in ((117, 203), (5, 7))}
    out = {}
    for name, (kern, plain) in cases(sig, mom, nrm, mp).items():
        ks, err = rel_err(kern, plain)
        for c in odd.values():
            err = max(err, rel_err(*c[name])[1])
        if err > 1e-4:
            raise AssertionError(f"K4 {name} max rel err {err}")
        reps = 3 if name == "atrous" else 1
        # per pixel: the channels a stencil reads (csrc/stencil.cu) once
        # and its outputs once; ~30 FLOP per tap (edge-stopping weights
        # with an exp and a pow, weighted sums)
        px, f32 = H * W, 4
        reads = {  # filter_moments: mom 0, 1, 3; both: mp 2, 3 (depth)
            "filter_moments": nbytes(sig, nrm) + px * f32 * (3 + 2),
            "variance_blur": nbytes(mom),
            "atrous": nbytes(sig, nrm) + px * f32 * 2}[name]
        taps = {"filter_moments": 49, "variance_blur": 9, "atrous": 25}[name]
        shape = f"{W}x{H}"
        if name == "atrous":
            # background pixels take no taps: what is left is staging
            # and stores, the traffic part of the kernel's time
            mp_bg = mp.clone()
            mp_bg[..., 2] = 0.0
            bg_ms = cuda_time(lambda: [sc.atrous(sig, nrm, mp_bg, s, phi_a,
                                                 phi_n) for s in (1, 2, 4)],
                              20) / reps
            shape += (f", per step (1, 2, 4); on an all-background copy "
                      f"(no taps) {bg_ms:.4f} ms per step")
        out[name] = dict(
            err=err, ms=cuda_time(kern, 20) / reps,
            plain_ms=cuda_time(plain, 2) / reps,
            bound=bound(reads + nbytes(*(ks[:1] if reps > 1 else ks)),
                        30.0 * taps * px),
            shape=shape + "; also within the gate at 203x117 and 7x5",
            tol="1e-4 relative to 1 + |plain|, at all three sizes")
    return out


def _textured_headline():
    from hybridrenderer_tpu_torch.scene import scene as scenes

    return scenes.stress_scene(num_objects=HEADLINE["objects"],
                               textured=True, tex_size=TEX_SIZE)


def check_sampler(dev):
    """The bilinear texture sampler at 1920x1080: the colour-slot lookups
    of one H-tex G-buffer (uv and colour texture ids from K1's attribute
    image over the textured headline scene), on the card against the CPU
    on the same inputs. The sampler is plain PyTorch on the card (the
    reference's is jnp gathers, no TPU kernel), so no kernel stands
    beside it; its time is what one sample site costs. Bound: the bytes
    the lookups need (uv and id read, RGBA written, and each distinct
    texel of the four taps read once)."""
    import torch

    from hybridrenderer_tpu_torch.ops import raster_cuda as rc
    from hybridrenderer_tpu_torch.ops import texture
    from hybridrenderer_tpu_torch.scene.schema import TextureStack

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _textured_headline().build(dev)
    rec, bbox, valid = rc.pack_candidates(_clipped(data, W, H, HEADLINE_CAM))
    ts, ec = rc.bin_candidates(bbox, valid, W, H)
    vis, a = rc.raster_tiles(rec, ts, ec, data.raster_rows, W, H)
    uv = a[..., 13:15].contiguous()
    tid = torch.where(vis.tri_id >= 0, a[..., 26].to(torch.int32), -1)
    ones = (1.0, 1.0, 1.0, 1.0)
    card = texture.sample_stack(data.textures, tid, uv, ones)
    cpu_stack = TextureStack(data=data.textures.data.cpu(),
                             sizes=data.textures.sizes.cpu())
    cpu = texture.sample_stack(cpu_stack, tid.cpu(), uv.cpu(), ones)
    err = (card.cpu() - cpu).abs().max().item()
    ms = cuda_time(lambda: texture.sample_stack(data.textures, tid, uv,
                                                ones), 20)
    # the distinct texels the four taps read
    sizes = data.textures.sizes.float()[tid.clamp(min=0).long()]
    N, TH, TW, _ = data.textures.data.shape
    x0 = torch.floor(uv[..., 0] * sizes[..., 1] - 0.5)
    y0 = torch.floor(uv[..., 1] * sizes[..., 0] - 0.5)
    w, h = sizes[..., 1].int(), sizes[..., 0].int()
    taps = [((tid.clamp(min=0).long() * TH + torch.remainder(
        (y0 + dy).int(), h)) * TW + torch.remainder((x0 + dx).int(), w))[
        tid >= 0] for dy in (0, 1) for dx in (0, 1)]
    texels = torch.unique(torch.cat(taps)).numel()
    b = bound(nbytes(uv, tid, card) + 16 * texels, 20.0 * H * W)
    log(f"[sampler] bilinear sample_stack, {W}x{H} H-tex colour lookups "
        f"({int((tid >= 0).sum())} textured pixels, {texels} distinct "
        f"texels of a {N}x{TH}x{TW} f32 stack): card vs CPU max abs err "
        f"{err:.3g} (tolerance {SAMPLER_TOL}); {ms:.4f} ms on the card, "
        f"bound {b[0]:.4f} ms ({b[1]}); {nvidia_smi_line()}")
    if err > SAMPLER_TOL:
        raise AssertionError(f"sampler card vs CPU max err {err}")


# ---------------------------------------------------------------------------
# phase 4-5: renders
# ---------------------------------------------------------------------------

def _hybrid_settings(width, height, extra=0, **kw):
    """bench.py's hybrid flags, with ``extra`` flags added."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType

    flags = (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
             | RenderFlags.SHADOW | RenderFlags.AO | RenderFlags.SVGF
             | RenderFlags.SVGF_TEMPORAL | RenderFlags.SVGF_SPATIAL
             | extra)
    return RenderSettings(width=width, height=height,
                          path=RenderPathType.HYBRID, flags=flags, **kw)


def _forward_settings(width, height, taa=True):
    """bench.py's forward flags (LIGHT | IBL | TAA)."""
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType

    flags = RenderFlags.LIGHT | RenderFlags.IBL
    return RenderSettings(width=width, height=height,
                          path=RenderPathType.FORWARD,
                          flags=flags | RenderFlags.TAA if taa else flags)


def _golden(dev, name, settings, scene_fn, cam_kw, frames, taa, gates):
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import raster_cuda
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    S = settings.width
    data = scene_fn().build(dev)
    r = Renderer.for_scene(settings, data)
    cam = OrbitCamera(width=S, height=S, **cam_kw)
    for _ in range(frames):
        img = to_u8(r.render_np(cam.step(taa_enabled=taa)))
    golden = read_png(os.path.join(ROOT, "tests", "goldens", name + ".png"))
    vis, _ = raster_cuda.rasterize_binned(
        _clipped(data, S, S, cam_kw), S, S, data.raster_rows)
    diff = np.abs(img.astype(int) - golden.astype(int))
    err = diff.max(axis=-1)
    off = err[~tri_boundary_mask(vis.tri_id.cpu().numpy(), dilate=1)]
    off_max, p99 = int(off.max()), float(np.percentile(diff, 99))
    log(f"[golden] {name}: off-edge max {off_max} u8 (gate {gates[0]}), "
        f"p99 {p99} (gate {gates[1]}), max {int(diff.max())}, mean "
        f"{diff.mean():.4f}")
    return off_max <= gates[0] and p99 <= gates[1]


def phase_golden(dev):
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.scene import scene as scenes
    from hybridrenderer_tpu_torch.scene.loader import load_scene_file

    glb = os.path.join(ROOT, "tests", "goldens", "textured_tri.glb")

    ok = [
        _golden(dev, "cube_hybrid_128", _hybrid_settings(128, 128, ao_block=8),
                scenes.cube_scene, GOLDEN_CAM, 2, False,
                (GOLDEN_OFF_EDGE_MAX, GOLDEN_P99_MAX)),
        _golden(dev, "cornell_full_128", _hybrid_settings(
                    128, 128, extra=RenderFlags.REFLECTION | RenderFlags.GI,
                    ao_block=8, gi_block=8),
                scenes.cornell_scene, CORNELL_CAM, 2, False,
                (FULL_GOLDEN_OFF_EDGE_MAX, FULL_GOLDEN_P99_MAX)),
        _golden(dev, "cube_forward_64", _forward_settings(64, 64, taa=False),
                scenes.cube_scene, GOLDEN_CAM, 1, False,
                (FORWARD_GOLDEN_OFF_EDGE_MAX, FORWARD_GOLDEN_P99_MAX)),
        _golden(dev, "cube_raytraced_128", _raytraced_settings(128, 128),
                scenes.cube_scene, GOLDEN_CAM, 2, True,
                (FORWARD_GOLDEN_OFF_EDGE_MAX, FORWARD_GOLDEN_P99_MAX)),
        _golden(dev, "stress_textured_128",
                _hybrid_settings(128, 128, ao_block=8, gi_block=8),
                lambda: scenes.stress_scene(num_objects=24, textured=True),
                STRESS_GOLDEN_CAM, 2, False, TEXTURED_GOLDEN_GATE),
        _golden(dev, "cutout_hybrid_128",
                _hybrid_settings(128, 128, ao_block=8, gi_block=8),
                scenes.cutout_scene, CUTOUT_CAM, 2, False,
                CUTOUT_GOLDEN_GATE),
        # the loader on the card's machine (no PIL there: the PNG reader)
        _golden(dev, "textured_gltf_96", _forward_settings(96, 96, taa=False),
                lambda: load_scene_file(glb), GLTF_CAM, 1, False,
                (FORWARD_GOLDEN_OFF_EDGE_MAX, FORWARD_GOLDEN_P99_MAX)),
    ]
    if not all(ok):
        raise AssertionError(f"golden gate failed: {ok}")


def frame_breakdown(name, r, cam, update=None):
    """Two more frames: one with a sync around each pass (per-pass ms on
    the host clock), one under torch.profiler (device time by kernel,
    device operations, busy share of the profiled frame's wall time).
    ``update``, a dynamic path's commit, runs before each frame, timed
    as its own pass and profiled with the frame."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    passes, spent = r.path.graph.passes, {}

    def timed(p, fn):
        def run(reg, ctx):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(reg, ctx)
            torch.cuda.synchronize()
            spent[p.name] = 1e3 * (time.perf_counter() - t)
            return out
        return run

    fns = [p.fn for p in passes]
    for p in passes:
        p.fn = timed(p, p.fn)
    try:
        if update is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
            update()
            torch.cuda.synchronize()
            spent["commit"] = 1e3 * (time.perf_counter() - t)
        r.render(cam.step(taa_enabled=True))
    finally:
        for p, fn in zip(passes, fns):
            p.fn = fn
    log(f"[{name}] per pass ms (sync around each): "
        + ", ".join(f"{k} {v:.3f}" for k, v in spent.items())
        + f"; sum {sum(spent.values()):.3f}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        if update is not None:
            update()
        r.render(cam.step(taa_enabled=True))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    # device-side events only (kernels, copies): an aten op's own entry
    # repeats the device time of the kernels it launched
    dev_ms = lambda e: getattr(e, "self_device_time_total", 0.0) / 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_ms(e) > 0.0]
    busy = sum(dev_ms(e) for e in events)
    if busy <= 0.0:
        log(f"[{name}] profiler: no device time recorded; not measured")
        return None
    ops = sum(e.count for e in events)
    top = sorted(events, key=dev_ms, reverse=True)[:8]
    log(f"[{name}] profiled frame: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall (share {busy / wall:.3f}), {ops} device "
        f"operations; top: " + "; ".join(
            f"{e.key[:60]} {dev_ms(e):.3f} ms x{e.count}" for e in top))
    return busy, ops


def rot_y(a):
    """bench.py's dynamic rung's entity rotation."""
    c, s = float(np.cos(a)), float(np.sin(a))
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)


def phase_render(dev, out_dir, name, settings, kernels, absent=(),
                 dynamic=False, host_fn=None, cam_kw=HEADLINE_CAM,
                 per_frame=None):
    """8 frames at 1920x1080 with the counts set to 0 just before and read
    just after; ``kernels`` must each have launched, ``absent`` none, and
    each kernel of ``per_frame`` exactly that many times a frame.
    ``host_fn`` makes the host scene (default: the stress scene of 250
    objects), seen from ``cam_kw``. ``dynamic``: bench.py's dynamic rung
    on a fresh scene: before frame k, entity 0 turns to rot_y(0.05 k) and
    DynamicScene.commit() updates the transforms and refits the tracer
    (timed apart, with a sync); the camera stays (its TAA jitter steps),
    as in the rung. Returns (the launch counts, the last frame, the
    profiled frame's (device ms, device operations) or None)."""
    import torch

    from hybridrenderer_tpu_torch import native
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.types import RenderPathType
    from hybridrenderer_tpu_torch.runtime.output import write_png
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes
    from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

    W, H, F = settings.width, settings.height, HEADLINE["frames"]
    host = scenes.stress_scene(num_objects=HEADLINE["objects"]) \
        if host_fn is None else host_fn()
    data = host.build(dev)
    t0 = time.perf_counter()
    r = Renderer.for_scene(settings, data)
    dyn = DynamicScene(host, r) if dynamic else None
    log(f"[{name}] {data.num_triangles} triangles; BVH build + renderer "
        f"{time.perf_counter() - t0:.2f} s")
    cam = OrbitCamera(width=W, height=H, **cam_kw)
    turn = [0]

    def update():
        turn[0] += 1
        dyn.set_entity_transform(0, rot_y(0.05 * turn[0]))
        dyn.commit()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    times, commits = [], []
    for _ in range(F):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if dyn is not None:
            update()
            torch.cuda.synchronize()
            commits.append(1e3 * (time.perf_counter() - t))
        out = r.render(cam.step(taa_enabled=True))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        if dyn is None:
            cam.orbit(0.01, 0.0)
    launches = {k.name: k.launches for k in native.KERNELS.values()
                if k.launches}
    plain = {k.name: k.plain_cuda_calls for k in native.KERNELS.values()}
    stats = r.frame_stats()
    img = out.cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"{name} output {img.shape} not finite")
    # the ray-traced path has no G-buffer, so no frame stats (as in the
    # reference)
    rt = settings.path == RenderPathType.RAYTRACED
    if img.max() <= 0.0 or (stats["covered_pixels"] <= 0 and not rt):
        raise AssertionError(f"{name} frame black or empty: {stats}")
    missing = [k for k in kernels if not launches.get(k)]
    stray = [k for k in absent if launches.get(k)]
    missing += [f"{k} {n} a frame" for k, n in (per_frame or {}).items()
                if launches.get(k, 0) != n * F]
    if missing or stray:
        raise AssertionError(f"{name}: kernels of the path never launched: "
                             f"{missing}; other kernels launched: {stray} "
                             f"({launches})")
    if any(plain.values()):
        raise AssertionError(f"{name}: plain versions ran on the card: "
                             f"{plain}")
    png = os.path.join(out_dir, f"chip_smoke_{name}.png")
    write_png(png, np.clip(img, 0.0, 1.0))
    med = float(np.median(times[2:]))
    log(f"[{name}] ms/frame per frame: {[round(t, 2) for t in times]}")
    if dyn is not None:
        log(f"[{name}] commit() ms (transform update + refit, in the frame "
            f"times above) per frame: {[round(t, 2) for t in commits]}; "
            f"median (frames 3-{F}) {float(np.median(commits[2:])):.2f}")
    wide = getattr(r.tracer, "wide", None)
    if wide is not None:
        log(f"[{name}] leaf pushes past the reference's 128 entries: "
            f"{int(wide.deep_pushes.item())}")
    log(f"[{name}] median ms/frame (frames 3-{F}) {med:.2f} on "
        f"{nvidia_smi_line()}; covered {stats['covered_pixels']}; "
        f"launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; image {png}")
    prof = frame_breakdown(name, r, cam, update if dyn is not None else None)
    return launches, img, prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=tempfile.gettempdir(),
                    help="directory for the rendered PNGs")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[env] TF32 off for matmul and cuDNN; float32 throughout")
    dev = torch.device("cuda", 0)
    torch.manual_seed(0)
    os.makedirs(args.out, exist_ok=True)

    from hybridrenderer_tpu_torch import native

    phase_environment()
    phase_build()
    # every check runs, so one call reports every failure; any failure
    # fails the script after the renders
    results, failures = {}, []
    for name, check in (("raster_tiles", check_raster),
                        ("trace_any", check_trace),
                        ("trace_closest", check_trace_closest),
                        ("packet_path", check_packet_path),
                        ("wide", check_wide),
                        ("temporal_fetch", check_temporal),
                        ("window_sample", check_window_sample),
                        ("stencils", check_stencils)):
        try:
            res = check(dev)
        except AssertionError as e:
            log(f"[kernel] {name} FAILED: {e}")
            failures.append(name)
            continue
        results.update(res if name in ("packet_path", "wide", "stencils")
                       else {name: res})
    for name, res in results.items():
        off = "" if native.KERNELS[name].on_path else \
            " (checked only: no path launches it)"
        lib = res.get("library_ms")
        log(f"[kernel] {name}: max err {res['err']:.3g} ({res['tol']}); "
            f"{res['ms']:.4f} ms kernel vs {res['plain_ms']:.4f} ms plain"
            + (f" vs {lib:.4f} ms library" if lib is not None else "")
            + f"; bound {res['bound'][0]:.4f} ms ({res['bound'][1]}) "
            f"at {res['shape']}{off}")
    try:
        check_sampler(dev)
    except AssertionError as e:
        log(f"[sampler] FAILED: {e}")
        failures.append("sampler")
    phase_golden(dev)
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.scene import scene as scenes

    W, H = HEADLINE["width"], HEADLINE["height"]
    hybrid = ["raster_tiles", "trace_any", "temporal_fetch",
              "filter_moments", "atrous"]
    wide = dict(trace_backend="pallas-wide")
    direct = ["trace_any", "trace_closest", "trace_packet"]
    runs = {
        "headline": phase_render(dev, args.out, "headline",
                                 _hybrid_settings(W, H), hybrid),
        "full_graph": phase_render(
            dev, args.out, "full_graph", _hybrid_settings(
                W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI),
            hybrid + ["trace_closest"]),
        "forward_taa": phase_render(dev, args.out, "forward_taa",
                                    _forward_settings(W, H),
                                    ["raster_tiles", "window_sample"]),
        "raytraced": phase_render(
            dev, args.out, "raytraced", _raytraced_settings(W, H),
            ["raster_tiles", "trace_closest", "trace_any", "window_sample"],
            absent=["raster_vis", "trace_packet"]),
        "raytraced_packet": phase_render(
            dev, args.out, "raytraced_packet", _raytraced_settings(
                W, H, raster_eval="v2", trace_backend="pallas"),
            ["raster_vis", "trace_packet", "window_sample"],
            absent=["raster_tiles", "trace_closest", "trace_any"]),
        "dynamic": phase_render(
            dev, args.out, "dynamic", _hybrid_settings(W, H), hybrid,
            absent=["trace_wide", "trace_mimt"], dynamic=True),
    }
    # textured and cut-out content: H-tex, F-tex (the headline and full
    # graph on the textured scene), C and RC (the cut-out scene on the
    # hybrid and ray-traced paths from its golden's camera: K1 twice a
    # frame, and every shadow, AO and primary ray's alpha rounds through
    # K2c, so no any-hit K2)
    runs["headline_tex"] = phase_render(
        dev, args.out, "headline_tex", _hybrid_settings(W, H), hybrid,
        host_fn=_textured_headline, per_frame={"raster_tiles": 1})
    runs["full_graph_tex"] = phase_render(
        dev, args.out, "full_graph_tex", _hybrid_settings(
            W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI),
        hybrid + ["trace_closest"], host_fn=_textured_headline)
    runs["cutout"] = phase_render(
        dev, args.out, "cutout", _hybrid_settings(W, H),
        ["raster_tiles", "trace_closest", "temporal_fetch", "filter_moments",
         "atrous"], absent=["trace_any"], host_fn=scenes.cutout_scene,
        cam_kw=CUTOUT_CAM, per_frame={"raster_tiles": 2})
    runs["raytraced_cutout"] = phase_render(
        dev, args.out, "raytraced_cutout", _raytraced_settings(W, H),
        ["raster_tiles", "trace_closest", "window_sample"],
        absent=["trace_any", "raster_vis", "trace_packet"],
        host_fn=scenes.cutout_scene, cam_kw=CUTOUT_CAM,
        per_frame={"raster_tiles": 1})
    for tex, base in (("headline_tex", "headline"),
                      ("full_graph_tex", "full_graph")):
        a, b = runs[tex][2], runs[base][2]
        if a is not None and b is not None:
            log(f"[{tex}] texture sample sites over {base}: "
                f"{a[0] - b[0]:+.3f} device ms ({a[0]:.3f} vs {b[0]:.3f}), "
                f"{a[1] - b[1]:+d} device operations ({a[1]} vs {b[1]}) "
                f"on {nvidia_smi_line()}")
    for kernel, k in (("trace_wide", "compressed"), ("trace_mimt", "mimt")):
        other = {"trace_wide": "trace_mimt", "trace_mimt": "trace_wide"}
        tag = {"trace_wide": "wide", "trace_mimt": "mimt"}[kernel]
        runs["dynamic_" + tag] = phase_render(
            dev, args.out, "dynamic_" + tag,
            _hybrid_settings(W, H, wide_kernel=k, **wide),
            [kernel if x == "trace_any" else x for x in hybrid],
            absent=direct + [other[kernel]], dynamic=True)
        runs["raytraced_" + tag] = phase_render(
            dev, args.out, "raytraced_" + tag,
            _raytraced_settings(W, H, wide_kernel=k, **wide),
            ["raster_tiles", kernel, "window_sample"],
            absent=direct + [other[kernel]])
    paths = {name: launches for name, (launches, _, _) in runs.items()}
    # the wide kernels change no visibility and no closest t: the dynamic
    # and ray-traced frames equal the K2 / K2c paths' frames
    for base in ("dynamic", "raytraced"):
        for tag in ("wide", "mimt"):
            diff = np.abs(runs[base][1] - runs[f"{base}_{tag}"][1])
            log(f"[{base}_{tag}] last frame against {base}'s: max abs "
                f"diff {diff.max():.3g}, {(diff > 1.0 / 255).mean():.2e} "
                f"of pixel channels beyond 1/255")
            if (diff > 1.0 / 255).mean() > 1e-3:
                failures.append(f"{base}_{tag} frame")
    if failures:
        raise AssertionError(f"checks failed: {failures}")

    kernels = []
    for name, res in results.items():
        k = native.KERNELS[name]
        if not k.on_path:
            continue
        per_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        kernels.append(dict(
            name=name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(per_path.values()), max_abs_err=res["err"],
            ms=res["ms"], plain_ms=res["plain_ms"], bound_ms=res["bound"][0],
            bound_by=res["bound"][1], library_ms=res.get("library_ms"),
            launches_per_path=per_path, shape=res["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
