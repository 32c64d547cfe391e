#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --find-big-scene   # only the search for
                                             # BIG_OBJECTS
    python3 chip_smoke.py --k5-against DIR   # only K5 against the K5 of
                                             # the tree in DIR (e.g. the
                                             # parent commit, unpacked)

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
   call's time (library), the kernels under 0.2 ms (K1 f32, vis-only and
   bf16, K1v, K3, K5, variance_blur), the hit-shading pair
   (hr_shade_hit, hr_shade_finish, on one 1080p full-graph frame's
   reflection and GI hits of the 1000-object scene from framebench's
   camera, exact), TAA's resolve pair (hr_taa_reproject,
   hr_taa_resolve, on the resolves of forward.orbit's 1080p frame, exact)
   and K5's library call as device
   time (device_time: graphs of calls over input sets no call finds in
   L2) beside their eager calls' time, K5 at the sharded frame's shard
   shape too; K1's bf16 mode (raster_attr_bits=16) beside
   its f32 mode; the bilinear texture sampler (plain PyTorch, no kernel)
   on one textured 1080p G-buffer's lookups against the CPU, with its
   time; and K2 / K2c over the bf16 triangles of a scene above the
   reference's 96 MiB record budget (R-w-big's, BIG_OBJECTS objects) on
   one 1080p ray-traced frame's primary and occlusion rays, exact; K1
   (f32 and vis-only) and K3 over the row windows of a SHARDS-way split
   of the 1080p frame (270 rows), exact against their plain versions
   and the whole image's rows; K2w over 8- and 16-triangle clusters
   (bvh_leaf_tris) on the four wide queries, exact, beside its bound
   and the 4-triangle time; the headline's shadow and AO rays as one
   shadow_query_pair (one K2 launch) against two queries, same
   visibility;
4. goldens: tests/goldens/cube_hybrid_128.png, cornell_full_128.png,
   cube_forward_64.png, cube_raytraced_128.png, stress_textured_128.png,
   cutout_hybrid_128.png, textured_gltf_96.png (tests/goldens/
   textured_tri.glb through the loader) and the display-mode goldens
   cube_display_{normal,depth,shadow}_128.png rendered on the card,
   held to the goldens off triangle edges, and the SHADOW golden's
   signal with SVGF off held to the port's own CPU frames;
5. renders, each of 8 frames on the stress scene (250 objects) at
   1920x1080 from bench.py's camera through the captured renderer
   (frames 1-2 run eagerly and capture their CUDA graphs, frames 3-8
   replay them), with the launch count of every kernel it runs (counts
   set to 0 just before it; a replay adds its graph's launches), a check
   that no plain version ran on the card, the capture times, per-pass
   device ms of replayed frames (a renderer made with trace=True, its
   device spans read through trace_totals) and one replayed frame
   under torch.profiler:
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
      DynamicScene.set_entity_transform and commit_and_render (transform
      update, refit and frame in one graph), on a fresh scene each run:
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
   i. the large-scene contract, 6 frames each: bench.py's Sponza-scale
      rungs on stress_scene(1000) (284,066 triangles), S (the headline's
      flags), S-tex (textured) and S-fwd-tex (forward + TAA, textured);
      F-1000 and R-1000, the full graph and the ray-traced path there,
      whose radiance hits shade from the quantized rows; R-w-big, the
      ray-traced path with wide_kernel "compressed" on BIG_OBJECTS
      objects (4 frames), which must trace K2 / K2c over bf16 triangles
      and launch no K2w, as the reference demotes it; H-a16, the
      headline with raster_attr_bits=16 (8 frames, K1's bf16 mode), with
      each rung's binning capacity a key;
   j. the wide tree's shapes and the fused query: D-w and R-w with
      bvh_leaf_tris=8 (K2w over 8-triangle clusters), R-w with
      bvh_width=16 (the reference demotes K2w: no K2w launch), each held
      to its default-shape frame; H with fuse_shadow_ao (one K2 launch
      a frame, the headline's last frame bit for bit).
   variance_blur is checked in phase 3 but launched by no path: its
   output feeds nothing (ops/svgf.py);
6. the captured frame: H, F, T, P, D and C at 1080p through the captured
   renderer against the same frames run eagerly (capture=False), bit for
   bit, 3 frames each (H and D 6, with both ms/frame) and one more after
   reset_history; render_burst of 8 headline frames, three times, against
   24 render() calls; a binning capacity fixed too small must raise before
   its frame commits, and the same view must then render at a capacity
   sized per key; the CLI (--scene stress --path hybrid --frames 3 at
   1920x1080, a process of its own) and the HTTP viewer (/frame.png and
   /input on localhost) on the card;
7. the row-sharded frame (parallel/): H, F, T and R at 1920x1080
   sharded SHARDS ways on cuda:0, 8 frames each through the
   single-device captured renderer, the eager sharded renderer
   (capture=False) and the captured sharded renderer (frames 1-2 eager
   and captured, 3-8 replayed): the captured sharded frames equal the
   eager sharded frames bit for bit and the single-device frames within
   2e-4 (the reference's tolerance), with the same kernel launches as
   the eager sharded frames; ms/frame, capture ms a key, device ms and
   busy share of one more replayed frame under the profiler, and peak
   MiB printed for each, with the counts set to 0 just before the
   captured sharded frames and every kernel of the path launched. Where
   more than one card is visible, H and R also render over make_mesh()
   (one shard a card) against the single-device frames.

The last three lines of standard output are the kernels' JSON record,
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Float32 throughout; TF32 is off for
matmul and cuDNN. The rendered images are written to DIR (default: the
system temporary directory).
"""
from __future__ import annotations

import argparse
import gc
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
# bench.py's Sponza-scale rungs (bench.py:251-290): 1000 objects, 284,066
# triangles, above the reference's exact shade-row table (98,304)
SPONZA_OBJECTS = 1000
# a stress scene just above the reference's 96 MiB budget for 8-wide f32
# records, so that its tracer traces bf16 triangles: 1,199,222 triangles,
# 100,687,872 bytes of records (4177 objects: 100,638,720, below). Found
# by `python3 chip_smoke.py --find-big-scene`, a bisection over the object
# count (the bytes are not monotone in it: 4185 objects give less than
# 4180), which prints each probe's triangles and bytes
BIG_OBJECTS = 4178
# the large-scene rungs run fewer frames than the 65k ones, to keep the
# run's length: 6 (R-w-big 4)
LARGE_FRAMES = 6
BIG_FRAMES = 4
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
# the display-mode goldens (tests/test_torch_display_goldens.py): NORMAL and
# DEPTH at bench.py's gate; SHADOW (two SVGF frames) at the reference's own
# jit-vs-eager reading plus 4 / 2
DISPLAY_GOLDENS = (("cube_display_normal_128", "NORMAL", 1, (16, 2.0)),
                   ("cube_display_depth_128", "DEPTH", 1, (16, 2.0)),
                   ("cube_display_shadow_128", "SHADOW", 2, (34, 8.0)))
# SVGF makes that golden's frames chaotic on the card too (card vs CPU 32 /
# 3): the tight witness beside its gate is its signal with SVGF off, card
# vs CPU, where one 1-spp ray a pixel can flip on an ulp
# (tests/test_torch_cuda.py)
SHADOW_SIGNAL_FLIPS = 4
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


def graph_time(fn, reps):
    """Mean ms per replay of ``fn``'s launches captured into one CUDA
    graph (after an eager warm-up), timed with CUDA events: the device's
    time for them, which the host's wrapper calls do not pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_time(graph.replay, reps)


# calls a graph of device_time replays, and the input sets they cycle over
GRAPH_CALLS = 10
INPUT_SETS = 4


def copies(args, n=INPUT_SETS):
    """``n`` input sets: ``args``, then copies of its tensors in memory of
    their own (other arguments shared)."""
    import torch

    return [args] + [tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args) for _ in range(n - 1)]


def device_time(fn, sets, calls=GRAPH_CALLS, reps=20):
    """Device ms per call of ``fn(*s)``: ``calls`` calls cycling over the
    input ``sets``, their outputs all kept, captured into one CUDA graph
    and replayed (graph_time), over ``calls``. The sets lie in memory of
    their own, so a call whose sets and outputs together pass the 50 MB
    L2 finds its inputs evicted by the calls between, as a frame's kernel
    finds its inputs; the host's wrapper calls do not pace it."""
    return graph_time(lambda: [fn(*sets[i % len(sets)])
                               for i in range(calls)], reps) / calls


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
    ms = device_time(rc.raster_tiles, copies(args))
    eager_ms = cuda_time(lambda: rc.raster_tiles(*args), 20)
    plain_ms = cuda_time(lambda: rc.raster_tiles_plain(*args), 2)
    # ~20 FLOP per (candidate, pixel) coverage test, every pixel of the
    # 16x16 tile of every tile entry (csrc/raster.cu)
    b = bound(nbytes(rec, ts, ec, data.raster_rows, vk.tri_id, vk.depth,
                     vk.bary1, vk.bary2, ak),
              20.0 * ec.shape[0] * rc.TILE * rc.TILE)
    return dict(err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound=b,
                shape=f"{W}x{H}, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates; exact too at {Wo}x{Ho} "
                      f"({ec_o.shape[0]} tile entries, up to {most_o} in a "
                      f"tile)",
                tol="exact (tri ids and all outputs), at both sizes")


def check_raster_bf16(dev):
    """K1's bf16 mode (raster_attr_bits=16) on the headline's 1080p
    candidates, against its plain version (the f32 raster rounded to
    nearest bf16), bit for bit; its bound counts the attribute image at
    2 bytes a value, half of the f32 mode's."""
    import torch

    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    rec, bbox, valid = rc.pack_candidates(_clipped(data, W, H, HEADLINE_CAM))
    ts, ec = rc.bin_candidates(bbox, valid, W, H)
    args = (rec, ts, ec, data.raster_rows, W, H)
    vk, ak = rc.raster_tiles(*args, attr_bits=16)
    vp, ap = rc.raster_tiles_bf16_plain(*args)
    same = all(torch.equal(a, b) for a, b in (
        (vk.tri_id, vp.tri_id), (vk.depth, vp.depth), (vk.bary1, vp.bary1),
        (vk.bary2, vp.bary2), (ak.view(torch.int16), ap.view(torch.int16))))
    if not same:
        raise AssertionError("K1's bf16 mode disagrees with its plain "
                             "version at 1920x1080")
    sets = copies(args)
    ms = device_time(lambda *a: rc.raster_tiles(*a, attr_bits=16), sets)
    ms32 = device_time(rc.raster_tiles, sets)
    eager_ms = cuda_time(lambda: rc.raster_tiles(*args, attr_bits=16), 20)
    plain_ms = cuda_time(lambda: rc.raster_tiles_bf16_plain(*args), 2)
    b = bound(nbytes(rec, ts, ec, data.raster_rows, vk.tri_id, vk.depth,
                     vk.bary1, vk.bary2, ak),
              20.0 * ec.shape[0] * rc.TILE * rc.TILE)
    log(f"[kernel] raster_tiles_bf16: {ms:.4f} ms against the f32 mode's "
        f"{ms32:.4f} ms in the same call (device time)")
    return dict(err=0.0, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound=b,
                shape=f"{W}x{H}, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates, bf16 attributes; the f32 "
                      f"mode {ms32:.4f} ms in the same call",
                tol="exact (tri ids, depth, barycentrics and the bf16 bits)")


# the row-sharded frames' split of the 1080p image (parallel/sharded.py)
SHARDS = 4


def check_raster_window(dev):
    """K1 (f32 attributes) and K1 vis-only over the row windows of a
    SHARDS-way split of the headline's 1920x1080 frame (270 rows each,
    which cut the 16-row bands): each window exact against its plain
    version, and the windows stacked equal to the whole image's K1
    outputs bit for bit. Times, replayed from CUDA graphs (device time):
    the windows' K1 launches against the whole image's in the same call;
    and the windows' eager calls, which the host paces."""
    import torch

    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    W, H = HEADLINE["width"], HEADLINE["height"]
    h = H // SHARDS
    data = _headline_scene(dev, HEADLINE["objects"])
    rec, bbox, valid = rc.pack_candidates(_clipped(data, W, H, HEADLINE_CAM))
    ts, ec = rc.bin_candidates(bbox, valid, W, H)
    whole = {a: rc.raster_tiles(rec, ts, ec, a, W, H)
             for a in (data.raster_rows, None)}
    windows, entries = [], 0
    for k in range(SHARDS):
        row0 = k * h
        ts_k, ec_k = rc.bin_candidates(bbox, valid, W, h, row0, H)
        entries += ec_k.shape[0]
        for a in (data.raster_rows, None):
            vk, ak = rc.raster_tiles(rec, ts_k, ec_k, a, W, h, row0=row0)
            vp, ap = rc.raster_tiles_plain(rec, ts_k, ec_k, a, W, h,
                                           row0=row0)
            vw, aw = whole[a]
            rows = slice(row0, row0 + h)
            for x, y, z in ((vk.tri_id, vp.tri_id, vw.tri_id[rows]),
                            (vk.depth, vp.depth, vw.depth[rows]),
                            (vk.bary1, vp.bary1, vw.bary1[rows]),
                            (vk.bary2, vp.bary2, vw.bary2[rows]),
                            (ak, ap, None if aw is None else aw[rows])):
                if x is None:
                    continue
                if not (torch.equal(x, y) and torch.equal(x, z)):
                    raise AssertionError(
                        f"K1 over rows {row0}..{row0 + h - 1} "
                        f"({'vis-only' if a is None else 'f32'}) differs "
                        f"from its plain version or the whole image's")
        windows.append((ts_k, ec_k, row0))

    def run_windows(a):
        for ts_k, ec_k, row0 in windows:
            rc.raster_tiles(rec, ts_k, ec_k, a, W, h, row0=row0)

    ms = graph_time(lambda: run_windows(data.raster_rows), 20)
    ms_vis = graph_time(lambda: run_windows(None), 20)
    eager_ms = cuda_time(lambda: run_windows(data.raster_rows), 20)
    whole_ms = graph_time(lambda: rc.raster_tiles(rec, ts, ec,
                                                  data.raster_rows, W, H), 20)
    whole_vis = graph_time(lambda: rc.raster_tiles(rec, ts, ec, None, W, H),
                           20)
    plain_ms = cuda_time(lambda: [rc.raster_tiles_plain(
        rec, t_, e_, data.raster_rows, W, h, row0=r0)
        for t_, e_, r0 in windows], 2)
    log(f"[kernel] raster_tiles row windows: {SHARDS} x {W}x{h} exact "
        f"against the plain version and the whole image's rows (f32 and "
        f"vis-only); {entries} tile entries against the whole image's "
        f"{ec.shape[0]}; replayed: {ms:.4f} ms for the {SHARDS} windows "
        f"(vis-only {ms_vis:.4f}) vs {whole_ms:.4f} ms whole (vis-only "
        f"{whole_vis:.4f}); eager calls {eager_ms:.4f}; plain "
        f"{plain_ms:.4f}; on {nvidia_smi_line()}")


def check_temporal_window(dev):
    """K3 over the row windows of a SHARDS-way split at 1920x1080: the
    current planes 270 rows, the history the whole image's; each window
    exact against its plain version and the whole image's K3 rows."""
    import torch

    from hybridrenderer_tpu_torch.ops import temporal_cuda

    H, W = HEADLINE["height"], HEADLINE["width"]
    h = H // SHARDS
    depth, oid, nrm, mp, g = _frame_planes(dev, H, W, 1)
    hist_sig = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    hist_mom = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    prev_depth = (depth * 1.01).contiguous()
    hist = (hist_sig, hist_mom, nrm, prev_depth, oid)
    whole = temporal_cuda.temporal_fetch(*hist, mp, nrm, oid)
    err, args = 0.0, []
    for k in range(SHARDS):
        rows = slice(k * h, (k + 1) * h)
        cur = tuple(x[rows].contiguous() for x in (mp, nrm, oid))
        args.append((*hist, *cur, k * h))
        kk = temporal_cuda.temporal_fetch(*args[-1])
        pp = temporal_cuda.temporal_fetch_plain(*args[-1])
        if not torch.equal(kk, whole[rows]):
            raise AssertionError(f"K3 over rows {rows} differs from the "
                                 f"whole image's")
        err = max(err, (kk - pp).abs().max().item())
    if err > 0.0:
        raise AssertionError(f"K3 row windows: max err {err} against the "
                             f"plain version")
    ms = graph_time(lambda: [temporal_cuda.temporal_fetch(*a)
                             for a in args], 50)
    eager_ms = cuda_time(lambda: [temporal_cuda.temporal_fetch(*a)
                                  for a in args], 50)
    whole_ms = graph_time(lambda: temporal_cuda.temporal_fetch(
        *hist, mp, nrm, oid), 50)
    log(f"[kernel] temporal_fetch row windows: {SHARDS} x {W}x{h} over the "
        f"{W}x{H} history, exact against the whole image's rows and the "
        f"plain version; replayed: {ms:.4f} ms for the {SHARDS} windows "
        f"vs {whole_ms:.4f} ms whole; eager calls {eager_ms:.4f}; on "
        f"{nvidia_smi_line()}")


def check_shadow_pair(dev):
    """The headline frame's shadow and AO queries at 1920x1080 as one
    shadow_query_pair (one K2 launch of 2R rays) against two
    shadow_query calls (two launches): visibility equal, one launch
    against two; both timed."""
    import torch

    from hybridrenderer_tpu_torch import native
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_hybrid_settings(W, H), data, capture=False)
    tracer, query, calls = r.tracer, r.tracer.shadow_query, []

    def recording(*a, **kw):
        calls.append((a, kw))
        return query(*a, **kw)

    tracer.shadow_query = recording
    r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
        taa_enabled=True))
    del tracer.shadow_query
    (wp, n, d_a, t_a), kw = calls[0]
    (_, _, d_b, t_b), _ = calls[1]
    act = kw["active"]
    k = native.KERNELS["trace_any"]
    n0 = k.launches
    pair = tracer.shadow_query_pair(wp, n, d_a, t_a, d_b, t_b, active=act)
    n1 = k.launches
    two = [tracer.shadow_query(*a, **kw_) for a, kw_ in calls]
    n2 = k.launches
    same = [torch.equal(x, y) for x, y in zip(pair, two)]
    if (n1 - n0, n2 - n1) != (1, 2) or not all(same):
        raise AssertionError(f"the pair: {n1 - n0} K2 launches against "
                             f"{n2 - n1}, visibility equal {same}")
    pair_ms = cuda_time(lambda: tracer.shadow_query_pair(
        wp, n, d_a, t_a, d_b, t_b, active=act), 10)
    two_ms = cuda_time(lambda: [tracer.shadow_query(*a, **kw_)
                                for a, kw_ in calls], 10)
    log(f"[kernel] shadow_query_pair: the headline's shadow and AO rays "
        f"({2 * W * H} rays) in 1 K2 launch, visibility equal to 2 "
        f"shadow_query launches; {pair_ms:.4f} ms vs {two_ms:.4f} ms (the "
        f"queries with their ray set-up) on {nvidia_smi_line()}")


def _big_scene():
    from hybridrenderer_tpu_torch.scene import scene as scenes

    return scenes.stress_scene(num_objects=BIG_OBJECTS)


def check_quantized_trace(dev):
    """K2 and K2c over a quantized scene (R-w-big: stress_scene of
    BIG_OBJECTS objects, trace_backend "pallas-wide", wide_kernel
    "compressed", which the reference demotes to its direct kernel over
    bf16 records) on the rays of one 1080p ray-traced frame: the primary
    rays (K2c) and their sun occlusion (K2), recorded as the path hands
    them to the tracer, against the plain versions: every triangle, t,
    u and v equal."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import trace_cuda
    from hybridrenderer_tpu_torch.ops.trace import (OCCLUSION_TMIN,
                                                    RADIANCE_TMIN,
                                                    VMEM_SCENE_BUDGET)
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    t0 = time.perf_counter()
    data = _big_scene().build(dev)
    r = Renderer.for_scene(_raytraced_settings(
        W, H, trace_backend="pallas-wide", wide_kernel="compressed"), data,
        capture=False)
    tracer = r.tracer
    log(f"[quantized] stress_scene({BIG_OBJECTS}): {data.num_triangles} "
        f"triangles, 8-wide f32 records {tracer.wide_bytes} bytes (budget "
        f"{VMEM_SCENE_BUDGET}); bf16 {tracer.quantized}, wide kernel "
        f"{tracer.wide_kernel}, demotion: {tracer.demotion}; scene + "
        f"tracer {time.perf_counter() - t0:.1f} s")
    if not tracer.quantized or tracer.wide_kernel is not None:
        raise AssertionError("R-w-big's tracer is not K2 / K2c over bf16 "
                             "triangles")
    closest, occl = [], []
    trace, occluded = tracer.trace_radiance, tracer.occluded

    def rec_radiance(scene, origin, direction, ctx, depth=0, active=None):
        closest.append(tracer.radiance_rays(origin, direction, active))
        return trace(scene, origin, direction, ctx, depth, active=active)

    def rec_occluded(origin, direction, tmax, active, width=0):
        R = origin.shape[0]
        occl.append((origin.contiguous(), direction.contiguous(),
                     torch.full((R,), float(tmax), device=origin.device),
                     active.contiguous()))
        return occluded(origin, direction, tmax, active, width)

    tracer.trace_radiance, tracer.occluded = rec_radiance, rec_occluded
    r.render(OrbitCamera(width=W, height=H, **HEADLINE_CAM).step(
        taa_enabled=True))
    del tracer.trace_radiance, tracer.occluded
    if len(closest) != 1 or len(occl) != 1:
        raise AssertionError(f"expected one primary and one occlusion "
                             f"query, got {len(closest)}, {len(occl)}")
    (o, d, t, a), (oo, od, ot, oa) = closest[0], occl[0]
    p = tracer.packed
    kc = trace_cuda.intersect_closest(p, o, d, RADIANCE_TMIN, t, a, W)
    pc = trace_cuda.intersect_closest_plain(p, o, d, RADIANCE_TMIN, t, a)
    ka = trace_cuda.intersect_any(p, oo, od, OCCLUSION_TMIN, ot, oa, W)
    pa = trace_cuda.intersect_any_plain(p, oo, od, OCCLUSION_TMIN, ot, oa)
    same = all(torch.equal(x, y) for x, y in zip(kc, pc)) \
        and torch.equal(ka, pa)
    hit = (pc[1] >= 0)[a].float().mean().item()
    ms_c = cuda_time(lambda: trace_cuda.intersect_closest(
        p, o, d, RADIANCE_TMIN, t, a, W), 10)
    ms_a = cuda_time(lambda: trace_cuda.intersect_any(
        p, oo, od, OCCLUSION_TMIN, ot, oa, W), 10)
    log(f"[quantized] K2c on {int(a.sum())} primary rays (hit {hit:.3f}) "
        f"{ms_c:.4f} ms, K2 on {int(oa.sum())} occlusion rays {ms_a:.4f} "
        f"ms, tree depth {p.depth}; equal to the plain versions: {same} "
        f"on {nvidia_smi_line()}")
    if not same:
        raise AssertionError("K2 / K2c over bf16 triangles disagree with "
                             "their plain versions")


def find_big_scene():
    """Bisection over stress_scene's object count for the smallest whose
    8-wide f32 records exceed the reference's 96 MiB budget (the scene
    built on the card, the SAH tree and the collapse on the host)."""
    import torch

    from hybridrenderer_tpu_torch.ops import bvh, bvh_wide, trace
    from hybridrenderer_tpu_torch.scene import scene as scenes

    dev = torch.device("cuda", 0)

    def size(n):
        s = scenes.stress_scene(num_objects=n).build(dev).triangles
        wide = bvh_wide.build_wide(bvh.build_sah(s.v0, s.v1, s.v2),
                                   s.v0, s.v1, s.v2)
        log(f"[big] stress_scene({n}): {s.count} triangles, records "
            f"{wide.vmem_bytes} bytes, meta {4 * wide.meta.numel()} bytes")
        return wide.vmem_bytes > trace.VMEM_SCENE_BUDGET

    lo, hi = 4000, 4700
    if size(lo) or not size(hi):
        raise AssertionError("the budget lies outside the search range")
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if size(mid) else (mid, hi)
    log(f"[big] smallest object count above the budget: {hi} "
        f"({lo} below)")


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
    # eager: the recorder runs once, in the frame it records
    r = Renderer.for_scene(_hybrid_settings(W, H), data, capture=False)
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


# framebench's camera: 50 units from (0, 2, 0) at pitch 0.5
BENCH_CAM = dict(HEADLINE_CAM, distance=50.0)


def check_shade(dev):
    """The hit-shading pair (hr_shade_hit, hr_shade_finish) on the
    radiance queries of one full-graph frame at 1920x1080 on the
    1000-object scene from framebench's camera (quantized shade rows,
    as full.orbit shades), recorded as the passes hand them over: each
    kernel against its plain version on the card at that stage's inputs,
    bit for bit, and its device time over both queries (device_time,
    the stage's few small PyTorch operations on its arguments included)
    beside its bound: the bytes the stage must move, each once (a
    ray's hit flag and outputs, a hit's ray and hit, the used 26 columns
    of each distinct hit triangle's shade row; in the finish a hit's
    terms, distance and visibilities, a miss's direction)."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.ops import shade_cuda
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, SPONZA_OBJECTS)
    r = Renderer.for_scene(_hybrid_settings(
        W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI), data,
        capture=False)
    tracer, trace, calls = r.tracer, r.tracer.trace_radiance, []

    def recording(scene, origin, direction, ctx, depth=0, active=None,
                  **kw):
        calls.append((origin, direction, active, ctx))
        return trace(scene, origin, direction, ctx, depth, active=active,
                     **kw)

    tracer.trace_radiance = recording
    r.render(OrbitCamera(width=W, height=H, **BENCH_CAM).step(
        taa_enabled=True))
    del tracer.trace_radiance
    if len(calls) != 2 or r.scene.shade_rows_q is None:
        raise AssertionError(f"expected the reflection and GI queries over "
                             f"quantized rows, got {len(calls)} queries")
    preps, finishes, bytes_p, bytes_f, hits = [], [], 0, 0, []
    for origin, direction, active, ctx in calls:
        h = tracer.radiance_hits(origin, direction, active)
        args = (tracer.shade_rows, r.scene, h.o, h.d, h.t, h.tri, h.u, h.v,
                h.hit, ctx, h.fwd, 0)
        k = shade_cuda.shade_hit_prepare(*args)
        p = shade_cuda.shade_hit_prepare_plain(*args)
        for name in ("occ_o", "occ_d", "occ_act", "terms"):
            a, b = getattr(k, name), getattr(p, name)
            if not torch_equal_nan(a, b):
                raise AssertionError(
                    f"hr_shade_hit's {name} differs from the plain "
                    f"version's at {int((a != b).sum())} values")
        R = h.o.shape[0]
        vis = tracer.occluded(k.occ_o, k.occ_d, shade_cuda.SHADOW_TMAX,
                              k.occ_act, h.width)
        sun_vis = vis[:R] if k.sun else None
        l_vis = vis[-R:] if k.nee else None
        fargs = (r.scene, ctx, k.terms, sun_vis, l_vis, h.hit, h.t, h.d,
                 h.pos)
        fk = shade_cuda.shade_hit_finish(*fargs)
        fp = shade_cuda.shade_hit_finish_plain(*fargs)
        if not all(torch_equal_nan(a, b) for a, b in zip(fk, fp)):
            raise AssertionError("hr_shade_finish differs from the plain "
                                 "version")
        preps.append(args)
        finishes.append(fargs)
        # what must move: a ray's hit flag and outputs; a hit's ray, hit
        # and shade row columns (each distinct row once), and in the
        # finish its terms, distance and visibilities; a miss's direction
        n_hit = int(h.hit.sum())
        rows = torch.unique(h.tri[h.hit]).numel()
        K = k.occ_act.numel() // R
        bytes_p += R * (1 + 25 * K + 4 * shade_cuda.TERMS) + n_hit * 40 \
            + rows * 26 * 4
        bytes_f += R * (1 + 16) + n_hit * (4 * shade_cuda.TERMS + 4
                                            + 4 * K) + (R - n_hit) * 12
        hits.append(n_hit)
    out = {}
    for name, fn, plain, arg_list, nb in (
            ("shade_hit", shade_cuda.shade_hit_prepare,
             shade_cuda.shade_hit_prepare_plain, preps, bytes_p),
            ("shade_finish", shade_cuda.shade_hit_finish,
             shade_cuda.shade_hit_finish_plain, finishes, bytes_f)):
        kern = lambda: [fn(*a) for a in arg_list]
        # two input sets of each query, in memory of their own
        sets = [c for a in arg_list for c in copies(a, 2)]
        out[name] = dict(
            err=0.0, ms=2 * device_time(fn, sets),
            eager_ms=cuda_time(kern, 10),
            plain_ms=cuda_time(lambda: [plain(*a) for a in arg_list], 1),
            bound=bound(nb, 0),
            shape=f"2 queries (reflection, GI) of {W * H} rays of one "
                  f"{W}x{H} full-graph frame on {SPONZA_OBJECTS} objects, "
                  f"{hits} hits; ms for both",
            tol="every output bit for bit")
    return out


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
        W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI), data,
        capture=False)
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
                                               trace_backend="pallas"), data,
                           capture=False)
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
    sets = copies(args)
    ms = device_time(lambda *a: rc.raster_tiles(*a, keyed=True), sets)
    k1_ms = device_time(rc.raster_tiles, sets)
    eager_ms = cuda_time(lambda: rc.raster_tiles(*args, keyed=True), 20)
    k1_eager = cuda_time(lambda: rc.raster_tiles(*args), 20)
    heavy_ms = cuda_time(lambda: rc.raster_tiles(*heavy_args, keyed=True),
                         20)
    heavy_k1_ms = cuda_time(lambda: rc.raster_tiles(*heavy_args), 20)
    log(f"[kernel] raster_vis bins: {hist}; the heaviest tile alone K1v "
        f"{heavy_ms:.4f} ms, K1 vis-only {heavy_k1_ms:.4f} ms (eager "
        f"calls); all tiles K1v {ms:.4f} ms, K1 vis-only {k1_ms:.4f} ms "
        f"(device time; eager calls {eager_ms:.4f}, {k1_eager:.4f})")
    # K1's ~20 FLOP per (candidate, pixel) coverage test and key; the
    # same bound holds K1 vis-only on these bins
    b = bound(nbytes(rec, ts, ec, k.tri_id, k.depth, k.bary1, k.bary2),
              20.0 * ec.shape[0] * rc.TILE * rc.TILE)
    return dict(err=err, ms=ms, eager_ms=eager_ms, plain_ms=cuda_time(
                    lambda: rc.raster_vis_plain(rec, ts, ec, W, H), 2),
                bound=b,
                shape=f"{W}x{H} depth prepass, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates ({hist}); the heaviest "
                      f"tile alone {heavy_ms:.4f} ms (eager); K1 vis-only on "
                      f"the same bins {k1_ms:.4f} ms, eager {k1_eager:.4f} "
                      f"ms (bound {b[0]:.4f} ms too; "
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
            r = Renderer.for_scene(settings, data, capture=False)
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
            data, tracers[0].bvh)


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

    queries, wide, data, tree = wide_queries(dev)
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
    check_wide_clusters(wide, tree, data, queries, ref, visits,
                        out["trace_wide"]["ms"])
    return out


def check_wide_clusters(wide4, tree, data, queries, ref, visits, ms4):
    """K2w over 8- and 16-triangle leaf clusters (bvh_leaf_tris) of the
    same binary tree, on the four wide queries: exact against its plain
    version (t, tri, u, v), no visibility flip and closest t equal
    against the per-ray K2 / K2c; timed beside its bound and the
    4-triangle clusters' time, with the build's registers, local memory
    and shared memory."""
    from hybridrenderer_tpu_torch.ops import trace_cuda as tc
    from hybridrenderer_tpu_torch.ops.bvh_wide import build_wide

    soup = data.triangles
    rays = [q[1:6] for q in queries]
    modes = [q[6] for q in queries]
    for leaf_tris in (8, 16):
        wide = build_wide(tree, soup.v0, soup.v1, soup.v2,
                          leaf_tris=leaf_tris)
        ks = [tc.intersect_wide(wide, *r, m) for r, m in zip(rays, modes)]
        steps = {}
        ps = [tc.intersect_wide_plain(wide, *r, m, visits=steps)
              for r, m in zip(rays, modes)]
        for (qn, *_), k, p in zip(queries, ks, ps):
            bad = [f for f, a, b in zip("t tri u v".split(), k, p)
                   if not torch_equal_nan(a, b)]
            if bad:
                raise AssertionError(f"K2w over {leaf_tris}-triangle "
                                     f"clusters differs from its plain "
                                     f"version on the {qn} rays in {bad}")
        flips, t_diff = 0, 0.0
        for r, m, k, ref_out in zip(rays, modes, ks, ref):
            tri = k[1].clone()
            tri[tri == tc.INACTIVE_TRI] = -1
            ref_tri = ref_out if m else ref_out[1]
            flips += int(((tri >= 0) != (ref_tri >= 0))[r[4]].sum())
            if not m:
                hit = (ref_tri >= 0) & r[4]
                t_diff = max(t_diff, (k[0] - ref_out[0]).abs()[hit].max()
                             .item())
        total = sum(int(r[4].sum()) for r in rays)
        if flips > 1e-3 * total or t_diff > 1e-4:
            raise AssertionError(f"K2w over {leaf_tris}-triangle clusters "
                                 f"against K2 / K2c: {flips} visibility "
                                 f"flips, closest t differs by {t_diff}")
        times = [cuda_time(lambda r=r, m=m: tc.intersect_wide(wide, *r, m),
                           5) for r, m in zip(rays, modes)]
        b = trace_bound((wide.nodes_flat, wide.leaves_flat, wide.meta),
                        [(r[0], r[1], r[3], r[4]) for r in rays],
                        [k if not m else k[1] for k, m in zip(ks, modes)],
                        visits)
        log(f"[kernel] trace_wide over {leaf_tris}-triangle clusters "
            f"(bvh_leaf_tris={leaf_tris}): exact against its plain version "
            f"on the four wide queries, {flips} visibility flips and closest "
            f"t within {t_diff:.3g} against K2 / K2c; "
            + " + ".join(f"{t:.4f}" for t in times)
            + f" = {sum(times):.4f} ms vs {ms4:.4f} ms over 4-triangle "
            f"clusters; bound {b[0]:.4f} ms ({b[1]}); tree of "
            f"{wide.num_wide} nodes, {wide.num_clusters} clusters "
            f"(4-triangle: {wide4.num_clusters}), records "
            f"{wide.vmem_bytes} bytes; packet pops {steps['internal']} "
            f"nodes, {steps['leaf']} clusters in {steps['steps']} program "
            f"steps; build {tc.wide_kernel_info(False, leaf_tris)} (shared "
            f"memory in bytes); on {nvidia_smi_line()}")


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
    ms = device_time(temporal_cuda.temporal_fetch, copies(args))
    eager_ms = cuda_time(lambda: temporal_cuda.temporal_fetch(*args), 50)
    plain_ms = cuda_time(lambda: temporal_cuda.temporal_fetch_plain(*args), 5)
    check_reproject(dev, H, W, hist_sig, hist_mom, prev_depth, oid, nrm, mp)
    # ~25 FLOP per tap (validation + 7 weighted sums), 4 taps a pixel
    return dict(err=err, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
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


# frames of the forward + TAA run whose TAA history fetches K5's timings
# cycle over (frames 3-6), and the sets of device_time: each fetch twice
K5_FRAMES = 4
K5_SETS = 2 * K5_FRAMES


def _window_sample_sets(dev):
    """The TAA history fetches of frames 3-6 of the forward + TAA frame at
    1920x1080 on the headline camera, orbiting (a three-plane f32 history
    and its reprojected uv each), each copied into memory of its own."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import taa, temporal_cuda
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    r = Renderer.for_scene(_forward_settings(W, H), data, capture=False)
    calls = []

    def recording(image, uv):
        # the history buffer is updated in place: keep this frame's copy
        calls.append((image.clone(), uv.clone()))
        return temporal_cuda.window_sample(image, uv)

    taa.window_sample = recording
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    try:
        for _ in range(2 + K5_FRAMES):
            r.render(cam.step(taa_enabled=True))
            cam.orbit(0.01, 0.0)
    finally:
        taa.window_sample = temporal_cuda.window_sample
    return calls[-K5_FRAMES:]


def _shard_fetch(image, uv):
    """A fetch at the sharded frame's shard shape: the whole 1080-row
    history and the uv of shard 1's 270 rows, as parallel/sharded.py
    launches K5 for each shard."""
    h = HEADLINE["height"] // SHARDS
    return image, uv[h:2 * h].contiguous()


def _grid_sample_args(image, uv):
    """grid_sample's inputs for K5's function: the image as (1, P, H, W)
    planes and the uv as (1, ..., 2) in [-1, 1]."""
    return (image.permute(2, 0, 1).unsqueeze(0).contiguous(),
            (uv * 2.0 - 1.0).unsqueeze(0))


def _grid_sample(planes, grid):
    """One PyTorch call computing K5's function (bilinear, border padding,
    align_corners=False); the port never calls it."""
    import torch.nn.functional as F

    return F.grid_sample(planes, grid, mode="bilinear", padding_mode="border",
                         align_corners=False)


def _k5_times(fn, fetches):
    """(device ms, eager ms) of ``fn`` on ``fetches``: device_time over
    K5_SETS sets in memory of their own, the eager calls on the first."""
    sets = fetches + [copies(f, 2)[1] for f in fetches]
    return (device_time(fn, sets),
            cuda_time(lambda: fn(*fetches[0]), 50))


def _k5_bound(image, uv, out):
    """K5's bound on one fetch: uv read and output written once, and of
    the image the rows its taps reach (all of them at 1080p; a shard's
    footprints reach about a quarter); 4 taps: ~10 FLOP of coordinates,
    6 per plane."""
    import torch

    H, W, P = image.shape
    y0 = torch.floor(uv[..., 1] * H - 0.5)
    rows = torch.unique(torch.cat([torch.clamp(y0, 0, H - 1),
                                   torch.clamp(y0 + 1.0, 0, H - 1)]))
    return bound(rows.numel() * W * P * 4 + nbytes(uv, out),
                 (10.0 + 6.0 * P) * uv.numel() // 2)


def check_window_sample(dev):
    """K5 on the TAA history fetches of the forward + TAA frame at
    1920x1080 on the headline camera (frames 3-6: a three-plane f32
    history and its reprojected uv each) and at the sharded frame's shard
    shape (the same histories, 270 rows of uv), against its plain version
    and against grid_sample, which computes the same function (bilinear,
    border padding, align_corners=False, uv * 2 - 1). Times: device time,
    over sets no call finds in L2 (device_time), beside the eager calls'."""
    from hybridrenderer_tpu_torch.ops import temporal_cuda

    W, H = HEADLINE["width"], HEADLINE["height"]
    fetches = _window_sample_sets(dev)
    shards = [_shard_fetch(*f) for f in fetches]
    err = 0.0
    for image, uv in fetches + shards:
        k = temporal_cuda.window_sample(image, uv)
        p = temporal_cuda.window_sample_plain(image, uv)
        err = max(err, (k - p).abs().max().item())
    if err > 0.0:
        raise AssertionError(f"K5 max err {err}")
    image, uv = fetches[-1]
    k = temporal_cuda.window_sample(image, uv)
    lib_err = (_grid_sample(*_grid_sample_args(image, uv))[0].permute(
        1, 2, 0) - k).abs().max().item()
    on = ((uv >= 0.0) & (uv <= 1.0)).all(-1).float().mean().item()
    P = image.shape[-1]
    ms, eager_ms = _k5_times(temporal_cuda.window_sample, fetches)
    lib_ms, lib_eager = _k5_times(
        _grid_sample, [_grid_sample_args(*f) for f in fetches])
    s_ms, s_eager = _k5_times(temporal_cuda.window_sample, shards)
    s_lib, s_lib_eager = _k5_times(
        _grid_sample, [_grid_sample_args(*f) for f in shards])
    s_bound = _k5_bound(*shards[-1], temporal_cuda.window_sample(*shards[-1]))
    h = shards[-1][1].shape[0]
    log(f"[kernel] window_sample at the shard shape ({W}x{h} uv over the "
        f"{W}x{H} history): {s_ms:.4f} ms device time (eager calls "
        f"{s_eager:.4f}), grid_sample {s_lib:.4f} (eager {s_lib_eager:.4f}), "
        f"bound {s_bound[0]:.4f} ms ({s_bound[1]}); on {nvidia_smi_line()}")
    return dict(err=err, ms=ms, eager_ms=eager_ms,
                plain_ms=cuda_time(lambda: temporal_cuda.window_sample_plain(
                    image, uv), 10),
                library_ms=lib_ms, library_eager_ms=lib_eager,
                bound=_k5_bound(image, uv, k),
                shape=f"{W}x{H}, {P} f32 planes (frames 3-6 of forward + "
                      f"TAA), {on:.4f} of uv on screen; grid_sample differs "
                      f"by {lib_err:.3g}; device time over {K5_SETS} sets; "
                      f"shard shape {W}x{h} uv: {s_ms:.4f} ms, grid_sample "
                      f"{s_lib:.4f}, bound {s_bound[0]:.4f}",
                tol="exact, at both shapes")


# a TAA frame's launches: the reprojection, the history fetch K5, the
# resolve
TAA = ["taa_reproject", "window_sample", "taa_resolve"]
# forward.orbit's frames whose TAA resolves check_taa records (3-6, a
# valid history and an orbiting camera)
TAA_FRAMES = 4


def check_taa(dev):
    """TAA's resolve pair (hr_taa_reproject, hr_taa_resolve) on the
    resolves of forward.orbit's frame: 1920x1080 forward + TAA with the
    sun's shadow ray on the 1000-object textured scene, framebench's
    camera orbiting 0.01 rad a frame, frames 3-6 recorded as the TAA pass
    hands them over. Each kernel against its plain version on the card
    at its stage's inputs (K5's sample between them), bit for bit, and
    its device time over those inputs (device_time) beside its bound:
    the bytes the stage must move, each once (reproject: depth, the
    winner's motion, prev_uv and alpha, 24 B a pixel; resolve: colour,
    the sample and alpha in, the colour out, 40 B a pixel). Prints the
    three launches' device time together beside their 96 B a pixel."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType
    from hybridrenderer_tpu_torch.ops import taa, taa_cuda, temporal_cuda
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = scenes.stress_scene(num_objects=SPONZA_OBJECTS, textured=True,
                               tex_size=TEX_SIZE).build(dev)
    s = RenderSettings(width=W, height=H, path=RenderPathType.FORWARD,
                       flags=RenderFlags.LIGHT | RenderFlags.IBL
                       | RenderFlags.EMISSIVE | RenderFlags.SHADOW
                       | RenderFlags.TAA)
    r = Renderer.for_scene(s, data, capture=False)
    resolve, calls = taa.resolve, []

    def recording(*a, **kw):
        # the history buffer is updated in place: keep this frame's copy
        calls.append((tuple(x.clone() for x in a), kw))
        return resolve(*a, **kw)

    taa.resolve = recording
    cam = OrbitCamera(width=W, height=H, **BENCH_CAM)
    try:
        for _ in range(2 + TAA_FRAMES):
            r.render(cam.step(taa_enabled=True))
            cam.orbit(0.01, 0.0)
    finally:
        taa.resolve = resolve
    del r
    reprojects, resolves, whole = [], [], []
    for (cur, hist, motion, depth, jit, prev_j), kw in calls[-TAA_FRAMES:]:
        if not kw["history_valid"] or cur.shape != (H, W, 3):
            raise AssertionError(f"unexpected TAA call: {kw}, "
                                 f"{tuple(cur.shape)}")
        rargs = (motion, depth, jit, prev_j, True, kw.get("row0", 0),
                 hist.shape[0])
        k_uv, k_alpha = taa_cuda.taa_reproject(*rargs)
        p_uv, p_alpha = taa_cuda.taa_reproject_plain(*rargs)
        for name, a, b in (("prev_uv", k_uv, p_uv), ("alpha", k_alpha,
                                                     p_alpha)):
            if not torch_equal_nan(a, b):
                raise AssertionError(
                    f"hr_taa_reproject's {name} differs from the plain "
                    f"version's at {int((a != b).sum())} values")
        sample = temporal_cuda.window_sample(hist, p_uv)
        sargs = (cur, sample, p_alpha)
        k = taa_cuda.taa_resolve(*sargs)
        p = taa_cuda.taa_resolve_plain(*sargs)
        if not torch_equal_nan(k, p):
            raise AssertionError(f"hr_taa_resolve differs from the plain "
                                 f"version's at {int((k != p).sum())} "
                                 f"values")
        if not torch_equal_nan(taa.resolve(cur, hist, motion, depth, jit,
                                           prev_j, True), p):
            raise AssertionError("taa.resolve differs from its plain stages")
        reprojects.append(rargs)
        resolves.append(sargs)
        whole.append((cur, hist, motion, depth, jit, prev_j, True))
    moving = float((p_alpha > 0.1).float().mean())
    on = float((p_alpha < 1.0).float().mean())
    px = W * H
    out = {}
    for name, fn, plain, sets, per_px in (
            ("taa_reproject", taa_cuda.taa_reproject,
             taa_cuda.taa_reproject_plain, reprojects, 24),
            ("taa_resolve", taa_cuda.taa_resolve,
             taa_cuda.taa_resolve_plain, resolves, 40)):
        out[name] = dict(
            err=0.0, ms=device_time(fn, sets),
            eager_ms=cuda_time(lambda: fn(*sets[0]), 20),
            plain_ms=cuda_time(lambda: plain(*sets[0]), 3),
            bound=bound(per_px * px, 0),
            shape=f"{W}x{H}, frames 3-{2 + TAA_FRAMES} of forward.orbit's "
                  f"frame ({SPONZA_OBJECTS} textured objects, framebench's "
                  f"camera): {on:.4f} of pixels blend history, {moving:.4f} "
                  f"with alpha above 0.1; device time over {TAA_FRAMES} "
                  f"sets",
            tol="every output bit for bit")
    ms = device_time(taa.resolve, whole)
    b = bound(96 * px, 0)
    log(f"[kernel] TAA resolve, all three launches (reproject, K5, "
        f"resolve): {ms:.4f} ms device time, bound {b[0]:.4f} ms "
        f"({b[1]}, 96 B a pixel), {100 * b[0] / ms:.1f}%; on "
        f"{nvidia_smi_line()}")
    return out


def k5_against(dev, other):
    """K5 of this checkout against K5 built from the tree in ``other``
    (by that tree's own native.py into its own build/; the parent commit
    unpacked with git archive, say) on the same fetches: both exact
    against the plain version at both shapes, then the device time of
    each at both shapes, in turns other, this, this, other, each turn
    with grid_sample's beside it, and the eager calls' times."""
    import ctypes

    import torch

    from hybridrenderer_tpu_torch.ops import temporal_cuda

    built = subprocess.run(
        [sys.executable, "-c", "from hybridrenderer_tpu_torch import native; "
         "native.kernel_library(); print(native.kernel_library_path())"],
        cwd=other, capture_output=True, text=True, timeout=900, check=True)
    entry = ctypes.CDLL(built.stdout.split()[-1]).hr_window_sample
    entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p, ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def other_k5(image, uv):
        H, W, P = image.shape
        out = torch.empty((*uv.shape[:-1], P), dtype=torch.float32,
                          device=uv.device)
        rc = entry(image.data_ptr(), H, W, P, uv.data_ptr(), uv.numel() // 2,
                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{other}'s K5: CUDA error {rc}")
        return out

    fetches = _window_sample_sets(dev)
    shapes = {"1920x1080": fetches,
              "shard": [_shard_fetch(*f) for f in fetches]}
    for name, fs in shapes.items():
        for fn in (other_k5, temporal_cuda.window_sample):
            err = max((fn(*f) - temporal_cuda.window_sample_plain(*f)).abs()
                      .max().item() for f in fs)
            if err > 0.0:
                raise AssertionError(f"K5 ({fn.__name__}) at {name}: max err "
                                     f"{err}")
    kernels = {"other": other_k5, "this": temporal_cuda.window_sample}
    rows = []
    for turn in ("other", "this", "this", "other"):
        for name, fs in shapes.items():
            ms, eager = _k5_times(kernels[turn], fs)
            lib, lib_eager = _k5_times(
                _grid_sample, [_grid_sample_args(*f) for f in fs])
            rows.append(dict(tree=turn, shape=name, ms=ms, eager_ms=eager,
                             grid_sample_ms=lib,
                             grid_sample_eager_ms=lib_eager))
            log(f"[k5] {turn:5s} {name:9s}: {ms:.4f} ms device time (eager "
                f"{eager:.4f}); grid_sample {lib:.4f} (eager {lib_eager:.4f})")
    log(f"[k5] both exact at both shapes; other tree {other}; on "
        f"{nvidia_smi_line()}")
    print(json.dumps({"k5_turns": rows}))


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
        ms = cuda_time(kern, 20) / reps
        timing = dict(ms=ms)
        if name == "variance_blur":
            # under 0.2 ms: device time, the eager calls' time beside it
            timing = dict(ms=device_time(sc.variance_blur, copies((mom,))),
                          eager_ms=ms)
        out[name] = dict(
            err=err, **timing, plain_ms=cuda_time(plain, 2) / reps,
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


def _shadow_signal(dev):
    """The SHADOW display golden's scene, camera and frames with SVGF off
    (the raw 1-spp shadow and AO signal) on the card against the port's
    CPU frames, off edges: at most SHADOW_SIGNAL_FLIPS pixels more than
    2 u8 apart, p99 1."""
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.types import DisplayMode, RenderFlags
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes

    settings = _hybrid_settings(128, 128, ao_block=8, gi_block=8,
                                display_mode=DisplayMode.SHADOW)
    settings = settings.replace(flags=settings.flags & ~(
        RenderFlags.SVGF | RenderFlags.SVGF_TEMPORAL
        | RenderFlags.SVGF_SPATIAL))
    imgs = []
    for d in ("cpu", dev):
        r = Renderer.for_scene(settings, scenes.cube_scene().build(d))
        cam = OrbitCamera(width=128, height=128, **GOLDEN_CAM)
        for _ in range(2):
            img = to_u8(r.render_np(cam.step()))
        imgs.append(img)
    edges = tri_boundary_mask(r.state.history["ObjectID"].cpu().numpy())
    diff = np.abs(imgs[0].astype(int) - imgs[1].astype(int))
    flips = int((diff.max(axis=-1)[~edges] > 2).sum())
    p99 = float(np.percentile(diff, 99))
    log(f"[golden] cube_display_shadow_128's signal with SVGF off, card vs "
        f"CPU: {flips} pixels more than 2 u8 apart off edges (gate "
        f"{SHADOW_SIGNAL_FLIPS}), p99 {p99} (gate 1.0)")
    return imgs[0].std() > 0 and flips <= SHADOW_SIGNAL_FLIPS and p99 <= 1.0


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
    from hybridrenderer_tpu_torch.core.types import DisplayMode

    for name, mode, frames, gate in DISPLAY_GOLDENS:
        ok.append(_golden(dev, name, _hybrid_settings(
            128, 128, ao_block=8, gi_block=8, display_mode=DisplayMode[mode]),
            scenes.cube_scene, GOLDEN_CAM, frames, False, gate))
    ok.append(_shadow_signal(dev))
    if not all(ok):
        raise AssertionError(f"golden gate failed: {ok}")


TRACED_FRAMES = 4


def frame_breakdown(name, dev, settings, host_fn, dynamic, cam, next_frame):
    """Device ms a frame of each pass, of the frame's glue outside the
    passes, of the commit and (dynamic paths) of the scene update and
    refit, over TRACED_FRAMES replayed frames of a renderer made with
    ``trace=True`` on a fresh scene (its device spans: event nodes of the
    captured graphs, runtime/profiling), after its two eager frames;
    then one more frame of the timed renderer, a replay, under
    torch.profiler (profiled_frame). ``next_frame(camera state)``
    renders a frame of the timed renderer as the path does."""
    traced, _, traced_frame = _path_renderer(dev, settings, host_fn,
                                             dynamic, trace=True)
    for k in range(2 + TRACED_FRAMES):
        if k == 2:
            traced.reset_trace()
        traced_frame(cam.step(taa_enabled=True))
    spans = {k: ms / n for k, (ms, n) in
             traced.trace_totals()["device"].items()}
    passes = [p.name for p in traced.path.graph.passes]
    rest = {"outside": spans["frame"] - sum(spans[p] for p in passes)}
    rest.update({k: v for k, v in spans.items()
                 if k not in passes and k != "frame"})
    log(f"[{name}] device ms a frame (replayed, device spans): "
        + ", ".join(f"{k} {v:.3f}" for k, v in
                    [*((p, spans[p]) for p in passes), *rest.items()])
        + f"; frame {spans['frame']:.3f}")
    del traced, traced_frame
    gc.collect()
    return profiled_frame(name, cam, next_frame)


def profiled_frame(name, cam, next_frame):
    """One more frame (a replay) under torch.profiler → (device ms, device
    operations, wall ms), or None where the profiler recorded no device
    time: device time by kernel, device operations, busy share of the
    frame's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        next_frame(cam.step(taa_enabled=True))
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
    log(f"[{name}] profiled replayed frame: device busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall (share {busy / wall:.3f}), {ops} device "
        f"operations; top: " + "; ".join(
            f"{e.key[:60]} {dev_ms(e):.3f} ms x{e.count}" for e in top))
    return busy, ops, wall


def _key(key) -> str:
    return "/".join(str(k) for k in key[:2])


def rot_y(a):
    """bench.py's dynamic rung's entity rotation."""
    c, s = float(np.cos(a)), float(np.sin(a))
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                     [0, 0, 0, 1]], np.float32)


def _path_renderer(dev, settings, host_fn, dynamic, capture=True,
                   trace=False):
    """(renderer, DynamicScene or None, next_frame) on a fresh scene:
    ``host_fn`` makes the host scene (default: the stress scene of 250
    objects). ``next_frame(camera state)`` renders the path's next frame:
    on a dynamic path entity 0 first turns to rot_y(0.05 k) before its
    k-th frame, and DynamicScene.commit_and_render updates the
    transforms, refits the tracer and renders in one call (one captured
    graph), as in bench.py's dynamic rung."""
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes
    from hybridrenderer_tpu_torch.scene.dynamic import DynamicScene

    host = scenes.stress_scene(num_objects=HEADLINE["objects"]) \
        if host_fn is None else host_fn()
    r = Renderer.for_scene(settings, host.build(dev), capture=capture,
                           trace=trace)
    dyn = DynamicScene(host, r) if dynamic else None
    turn = [0]

    def next_frame(cs):
        if dyn is None:
            return r.render(cs)
        turn[0] += 1
        dyn.set_entity_transform(0, rot_y(0.05 * turn[0]))
        return dyn.commit_and_render(cs)

    return r, dyn, next_frame


def phase_render(dev, out_dir, name, settings, kernels, absent=(),
                 dynamic=False, host_fn=None, cam_kw=HEADLINE_CAM,
                 per_frame=None, frames=None, check=None):
    """``frames`` (default 8) frames at 1920x1080 through the captured
    renderer (frames 1 and 2 run eagerly and capture their keys' graphs,
    the later frames replay) with
    the counts set to 0 just before and read just after; ``kernels`` must
    each have launched, ``absent`` none, and each kernel of ``per_frame``
    exactly that many times a frame (replays count the launches their
    graph captured). ``host_fn`` and ``dynamic`` as for _path_renderer;
    the camera, seen from ``cam_kw``, orbits 0.01 rad a frame but on the
    dynamic paths (its TAA jitter steps); ``check(renderer)`` raises on
    what the rung must show of its scene and tracer. Returns (the launch
    counts, the last frame, the profiled frame's (device ms, device
    operations) or None, the median ms/frame)."""
    import torch

    from hybridrenderer_tpu_torch import native
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.core.types import RenderPathType
    from hybridrenderer_tpu_torch.runtime.output import write_png

    W, H = settings.width, settings.height
    F = HEADLINE["frames"] if frames is None else frames
    t0 = time.perf_counter()
    r, dyn, next_frame = _path_renderer(dev, settings, host_fn, dynamic)
    tracer = r.tracer
    rows = "exact" if r.scene.shade_rows_q is None else "quantized"
    log(f"[{name}] {r.scene.num_triangles} triangles; BVH build + renderer "
        f"{time.perf_counter() - t0:.2f} s; hit shading from {rows} rows"
        + ("" if tracer is None else
           f"; tracer {tracer.backend}, wide kernel {tracer.wide_kernel}, "
           f"bf16 triangles {tracer.quantized}, wide records "
           f"{tracer.wide_bytes} bytes, demotion {tracer.demotion}"))
    if check is not None:
        check(r)
    cam = OrbitCamera(width=W, height=H, **cam_kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    native.reset_counts()
    times = []
    for _ in range(F):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = next_frame(cam.step(taa_enabled=True))
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
    keys = sorted(r._graphs)
    if len(keys) != 2:
        raise AssertionError(f"{name}: expected the first and the later "
                             f"frames' graphs, got {keys}")
    png = os.path.join(out_dir, f"chip_smoke_{name}.png")
    write_png(png, np.clip(img, 0.0, 1.0))
    med = float(np.median(times[2:]))
    log(f"[{name}] ms/frame per frame (1-2 eager + capture, 3-{F} "
        f"replayed): {[round(t, 2) for t in times]}; capture ms "
        f"{ {k: round(v, 1) for k, v in r.capture_ms.items()} }")
    wide = getattr(r.tracer, "wide", None)
    if wide is not None:
        log(f"[{name}] leaf pushes past the reference's 128 entries: "
            f"{int(wide.deep_pushes.item())}")
    capacity = {_key(k): g.capacity for k, g in r._graphs.items()}
    log(f"[{name}] median ms/frame (frames 3-{F}, replayed) {med:.2f} on "
        f"{nvidia_smi_line()}; covered {stats['covered_pixels']}; "
        f"launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; binning "
        f"capacity {capacity}; image {png}")
    prof = frame_breakdown(name, dev, settings, host_fn, dynamic, cam,
                           next_frame)
    return launches, img, prof, med


# phase 7: the row-sharded frame (parallel/sharded.py)
SHARDED_FRAMES = 8
# the reference's tolerance for its sharded frames with ray passes
# (tests/test_parallel.py)
SHARDED_TOL = 2e-4


def _sharded_run(name, make, settings, profiled):
    """SHARDED_FRAMES frames at 1920x1080 through ``make()``'s renderer,
    the camera seen from HEADLINE_CAM orbiting 0.01 rad a frame, with
    the counts set to 0 just before and read just after, and with
    ``profiled`` one more frame under the profiler → dict: frames (on
    the host), ms per frame (host clock, every card synchronised), peak
    MiB, launches, plain calls on the card, the renderer, the profiled
    frame (profiled_frame) or None."""
    import torch

    from hybridrenderer_tpu_torch import native
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera

    def sync():
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)

    W, H = settings.width, settings.height
    gc.collect()            # an earlier run's renderer and its graphs
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = make()
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    native.reset_counts()
    frames, ms = [], []
    for _ in range(SHARDED_FRAMES):
        sync()
        t = time.perf_counter()
        img = r.render(cam.step(taa_enabled=True))
        sync()
        ms.append(1e3 * (time.perf_counter() - t))
        frames.append(img.cpu().numpy())
        cam.orbit(0.01, 0.0)
    run = dict(
        frames=frames, ms=ms, renderer=r,
        launches={k.name: k.launches for k in native.KERNELS.values()
                  if k.launches},
        plain={k.name: k.plain_cuda_calls for k in native.KERNELS.values()
               if k.plain_cuda_calls},
        peak=torch.cuda.max_memory_allocated() / 2**20)
    run["prof"] = profiled_frame(name, cam, r.render) if profiled else None
    return run


def _max_diff(a, b):
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


def phase_sharded(dev, out_dir):
    """H, F, T and R at 1920x1080 sharded SHARDS ways on one card (every
    shard on ``dev``), SHARDED_FRAMES frames each through the
    single-device captured renderer, the eager sharded renderer and the
    captured sharded renderer (frames 1-2 eager and captured, later ones
    replayed): the captured sharded frames must equal the eager sharded
    frames bit for bit, with the same kernel launches, and the
    single-device frames within SHARDED_TOL, every kernel of the path
    launched and no plain version on the card. Prints ms/frame, capture
    ms, device ms and busy share of a profiled replay, and peak MiB of
    each. With more than one card visible, H and R also render over
    make_mesh(). → ({path: the captured sharded run's launches},
    failures)."""
    import torch

    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
    from hybridrenderer_tpu_torch.runtime.output import write_png
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H = HEADLINE["width"], HEADLINE["height"]
    mesh = make_mesh(devices=[dev] * SHARDS)
    data = _headline_scene(dev, HEADLINE["objects"])
    hybrid = ["raster_tiles", "trace_any", "temporal_fetch",
              "filter_moments", "atrous"]
    paths = (
        ("H", _hybrid_settings(W, H), hybrid),
        ("F", _hybrid_settings(
            W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI),
         hybrid + ["trace_closest"]),
        ("T", _forward_settings(W, H), ["raster_tiles"] + TAA),
        ("R", _raytraced_settings(W, H),
         ["raster_tiles", "trace_closest", "trace_any"] + TAA))
    smi = nvidia_smi_line()
    out, failures, singles = {}, [], {}
    for name, settings, kernels in paths:
        tag = f"sharded {name}"
        # each run's peak memory is its own: the renderer before it is
        # dropped first
        single = _sharded_run(f"{tag} single", lambda: Renderer.for_scene(
            settings, data), settings, True)
        del single["renderer"]
        singles[name] = single["frames"]
        eager = _sharded_run(f"{tag} eager", lambda: ShardedRenderer.for_scene(
            settings, data, mesh, capture=False), settings, False)
        del eager["renderer"]
        cap = _sharded_run(f"{tag} captured", lambda: ShardedRenderer
                           .for_scene(settings, data, mesh), settings, True)
        r = cap.pop("renderer")
        keys = sorted(r._graphs)
        img = cap["frames"][-1]
        write_png(os.path.join(out_dir, f"chip_smoke_sharded_{name}.png"),
                  np.clip(img, 0.0, 1.0))
        same = all(np.array_equal(a, b)
                   for a, b in zip(cap["frames"], eager["frames"]))
        d_cap = [float(np.abs(a - b).max())
                 for a, b in zip(cap["frames"], single["frames"])]
        d_eager = _max_diff(eager["frames"], single["frames"])
        missing = [k for k in kernels if not cap["launches"].get(k)]
        ok = (same and not missing and not cap["plain"]
              and cap["launches"] == eager["launches"]
              and max(d_cap) <= SHARDED_TOL and d_eager <= SHARDED_TOL
              and len(keys) == 2 and img.shape == (H, W, 3)
              and np.isfinite(img).all())
        med = {k: float(np.median(run["ms"][2:]))
               for k, run in (("single", single), ("captured", cap))}
        prof = {k: run["prof"] for k, run in (("single", single),
                                              ("captured", cap))}
        busy = {k: "not measured" if p is None else
                f"{p[0]:.3f} device ms ({p[1]} operations), busy share "
                f"{p[0] / p[2]:.3f}, device / frame {p[0] / med[k]:.3f}"
                for k, p in prof.items()}
        log(f"[{tag}] {SHARDS} shards of {W}x{H // SHARDS} on {dev}, "
            f"{SHARDED_FRAMES} frames: captured frames against the eager "
            f"sharded frames bit for bit {same}, max abs diff against the "
            f"single-device frames {d_cap} (eager sharded {d_eager}; tol "
            f"{SHARDED_TOL}); launches captured {cap['launches']}, eager "
            f"sharded {eager['launches']}; plain on the card "
            f"{cap['plain']}; keys {keys}; frame stats {r.frame_stats()}")
        capacity = {_key(k): g.capacity for k, g in r._graphs.items()}
        log(f"[{tag}] captured ms/frame (1-2 eager + capture, "
            f"3-{SHARDED_FRAMES} replayed) "
            f"{[round(t, 2) for t in cap['ms']]}, "
            f"median {med['captured']:.2f}; capture ms "
            f"{ {k: round(v, 1) for k, v in r.capture_ms.items()} }; "
            f"{busy['captured']}; peak MiB {cap['peak']:.1f}; binning "
            f"capacity {capacity}")
        log(f"[{tag}] single-device captured ms/frame "
            f"{[round(t, 2) for t in single['ms']]}, median "
            f"{med['single']:.2f}; {busy['single']}; peak MiB "
            f"{single['peak']:.1f}; eager sharded ms/frame "
            f"{[round(t, 2) for t in eager['ms']]}; peak MiB "
            f"{eager['peak']:.1f}; on {smi}: "
            + ("ok" if ok else f"FAILED (never launched: {missing})"))
        if not ok:
            failures.append(tag)
        out[f"sharded_{name}"] = cap["launches"]
        del r, cap, eager, single
    return out, failures + phase_sharded_cards(dev, data, singles)


def phase_sharded_cards(dev, data=None, singles=None):
    """With more than one card visible: H and R at 1920x1080 over
    make_mesh() (one shard a card, as many cards as divide the rows),
    SHARDED_FRAMES frames through the captured sharded renderer against
    the single-device frames ``singles`` ({path: frames}; rendered here
    where not given) within SHARDED_TOL; prints the cards used and the
    ms/frame. Otherwise prints that the multi-card case did not run. →
    failures."""
    import torch

    from hybridrenderer_tpu_torch.parallel.mesh import make_mesh
    from hybridrenderer_tpu_torch.parallel.sharded import ShardedRenderer
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[sharded cards] the multi-card case did not run: {cards} "
            f"CUDA device visible")
        return []
    W, H = HEADLINE["width"], HEADLINE["height"]
    if data is None:
        data = _headline_scene(dev, HEADLINE["objects"])
    n = max(k for k in range(2, cards + 1) if H % k == 0)
    mesh = make_mesh(n)
    failures = []
    for name, settings in (("H", _hybrid_settings(W, H)),
                           ("R", _raytraced_settings(W, H))):
        tag = f"sharded {name} cards"
        single = (singles or {}).get(name)
        if single is None:
            single = _sharded_run(f"{tag} single", lambda: Renderer
                                  .for_scene(settings, data), settings,
                                  False)["frames"]
        run = _sharded_run(tag, lambda: ShardedRenderer.for_scene(
            settings, data, mesh), settings, False)
        r = run.pop("renderer")
        diff = _max_diff(run["frames"], single)
        ok = diff <= SHARDED_TOL and len(r._graphs) == 2
        log(f"[{tag}] {n} shards of {W}x{H // n} over {n} cards ({cards} "
            f"visible: {[torch.cuda.get_device_name(i) for i in range(n)]})"
            f", {SHARDED_FRAMES} frames: max abs diff against the "
            f"single-device frames {diff} (tol {SHARDED_TOL}); ms/frame "
            f"(1-2 eager + capture, 3-{SHARDED_FRAMES} replayed) "
            f"{[round(t, 2) for t in run['ms']]}, median "
            f"{float(np.median(run['ms'][2:])):.2f}; capture ms "
            f"{ {k: round(v, 1) for k, v in r.capture_ms.items()} }"
            f"; peak MiB on {dev} {run['peak']:.1f}; on {nvidia_smi_line()}"
            f": " + ("ok" if ok else "FAILED"))
        if not ok:
            failures.append(tag)
        del r, run
    return failures


def _wide_rungs(dev, out_dir, runs):
    """The wide tree's shapes and the fused shadow + AO query at
    1920x1080 through the captured renderer (phase_render): D-w and R-w
    over 8-triangle clusters (K2w), R-w over a 16-wide tree (which the
    reference demotes: no K2w launch), each held to its default-shape
    frame as phase 5 holds the wide paths to K2 / K2c's; and H with
    fuse_shadow_ao, one K2 launch a frame (the headline's two), its last
    frame equal to the headline's bit for bit. → failures."""
    W, H = HEADLINE["width"], HEADLINE["height"]
    wide = dict(trace_backend="pallas-wide", wide_kernel="compressed")
    direct = ["trace_any", "trace_closest", "trace_packet", "trace_mimt"]
    hybrid = ["raster_tiles", "trace_any", "temporal_fetch",
              "filter_moments", "atrous"]

    def shape(width, leaf_tris):
        def check(r):
            w = r.tracer.wide
            if w is not None and (w.width, w.leaf_tris) != (width,
                                                            leaf_tris):
                raise AssertionError(f"wide tree {w.width} wide, "
                                     f"{w.leaf_tris} triangles a cluster")
        return check

    def demoted(r):
        if r.tracer.wide_kernel is not None or r.tracer.demotion is None:
            raise AssertionError("a 16-wide tree's tracer is not K2 / K2c")

    runs["dynamic_wide_l8"] = phase_render(
        dev, out_dir, "dynamic_wide_l8",
        _hybrid_settings(W, H, bvh_leaf_tris=8, **wide),
        ["trace_wide" if x == "trace_any" else x for x in hybrid],
        absent=direct, dynamic=True, check=shape(8, 8))
    runs["raytraced_wide_l8"] = phase_render(
        dev, out_dir, "raytraced_wide_l8",
        _raytraced_settings(W, H, bvh_leaf_tris=8, **wide),
        ["raster_tiles", "trace_wide"] + TAA, absent=direct,
        check=shape(8, 8))
    runs["raytraced_wide_w16"] = phase_render(
        dev, out_dir, "raytraced_wide_w16",
        _raytraced_settings(W, H, bvh_width=16, **wide),
        ["raster_tiles", "trace_closest", "trace_any"] + TAA,
        absent=["trace_wide", "trace_mimt"], check=demoted)
    runs["headline_fused"] = phase_render(
        dev, out_dir, "headline_fused",
        _hybrid_settings(W, H, fuse_shadow_ao=True), hybrid,
        per_frame={"trace_any": 1})
    failures = []
    frames = HEADLINE["frames"]
    if runs["headline"][0].get("trace_any") != 2 * frames:
        failures.append("headline: not two K2 launches a frame")
    same = np.array_equal(runs["headline_fused"][1], runs["headline"][1])
    log(f"[headline_fused] one K2 launch a frame against the headline's "
        f"two; last frame equal to the headline's bit for bit: {same}")
    if not same:
        failures.append("headline_fused frame")
    for rung, base in (("dynamic_wide_l8", "dynamic"),
                       ("raytraced_wide_l8", "raytraced"),
                       ("raytraced_wide_w16", "raytraced")):
        diff = np.abs(runs[base][1] - runs[rung][1])
        log(f"[{rung}] last frame against {base}'s: max abs diff "
            f"{diff.max():.3g}, {(diff > 1.0 / 255).mean():.2e} of pixel "
            f"channels beyond 1/255")
        if (diff > 1.0 / 255).mean() > 1e-3:
            failures.append(f"{rung} frame")
    return failures


# phase 6: the captured frame against the eager frame, the burst, the
# binning overflow, the CLI and the viewer
CAPTURE_FRAMES = 3


def _capture_cases():
    """name → (settings, host_fn, camera, dynamic, frames) of the paths
    held captured against eager; H and D run 6 frames for their timing."""
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.scene import scene as scenes

    W, H = HEADLINE["width"], HEADLINE["height"]
    return {
        "H": (_hybrid_settings(W, H), None, HEADLINE_CAM, False, 6),
        "F": (_hybrid_settings(W, H, extra=RenderFlags.REFLECTION
                               | RenderFlags.GI), None, HEADLINE_CAM, False,
              CAPTURE_FRAMES),
        "T": (_forward_settings(W, H), None, HEADLINE_CAM, False,
              CAPTURE_FRAMES),
        "P": (_raytraced_settings(W, H, raster_eval="v2",
                                  trace_backend="pallas"), None,
              HEADLINE_CAM, False, CAPTURE_FRAMES),
        "D": (_hybrid_settings(W, H), None, HEADLINE_CAM, True, 6),
        "C": (_hybrid_settings(W, H), scenes.cutout_scene, CUTOUT_CAM, False,
              CAPTURE_FRAMES),
    }


def _drive(dev, case, capture):
    """A capture case's frames, then reset_history and one more frame
    (the first frame's graph replayed) → (images, ms/frame per frame)."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera

    settings, host_fn, cam_kw, dynamic, frames = case
    r, dyn, next_frame = _path_renderer(dev, settings, host_fn, dynamic,
                                        capture)
    cam = OrbitCamera(width=settings.width, height=settings.height,
                      **cam_kw)
    imgs, times = [], []
    for _ in range(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        imgs.append(next_frame(cam.step(taa_enabled=True)))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        if dyn is None:
            cam.orbit(0.01, 0.0)
    r.reset_history()
    imgs.append(next_frame(cam.step(taa_enabled=True)))
    return imgs, times


def phase_captured_vs_eager(dev):
    """H, F, T, P, D, C at 1080p through the captured renderer and eagerly
    (capture=False): every frame equal bit for bit; the captured and the
    eager ms/frame (the median of frames 3-6 for H and D, frame 3 for the
    others)."""
    failures = []
    for name, case in _capture_cases().items():
        captured, t_cap = _drive(dev, case, True)
        eager, t_eager = _drive(dev, case, False)
        same = [bool((a == b).all()) for a, b in zip(captured, eager)]
        line = (f"[captured vs eager] {name}: {len(same)} frames (the last "
                f"after reset_history) equal bit for bit: {same}")
        line += (f"; median ms/frame (frames 3-{case[4]}) captured "
                 f"{float(np.median(t_cap[2:])):.2f}, eager "
                 f"{float(np.median(t_eager[2:])):.2f} on "
                 f"{nvidia_smi_line()}")
        log(line)
        if not all(same):
            failures.append(f"captured vs eager {name}")
    return failures


def phase_burst(dev):
    """render_burst of 8 headline frames, three times (a burst replays
    render()'s graphs once a frame; its frames 1 and 2 run eagerly and
    capture them), against 24 render() calls: equal bit for bit; the
    third burst's ms a frame beside the replayed render()'s."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera

    W, H, K = HEADLINE["width"], HEADLINE["height"], HEADLINE["frames"]
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    cams = []
    for _ in range(3 * K):
        cams.append(cam.step(taa_enabled=True))
        cam.orbit(0.01, 0.0)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t) / K

    seq, _, _ = _path_renderer(dev, _hybrid_settings(W, H), None, False)
    frames = [seq.render(cs) for cs in cams[:2 * K]]
    last, seq_ms = timed(lambda: [seq.render(cs) for cs in cams[2 * K:]])
    bur, _, _ = _path_renderer(dev, _hybrid_settings(W, H), None, False)
    bursts = [bur.render_burst(cams[i * K:(i + 1) * K]) for i in range(2)]
    third, ms = timed(lambda: bur.render_burst(cams[2 * K:]))
    same = [bool((a == b).all()) for a, b in
            zip([f for b in bursts + [third] for f in b], frames + last)]
    log(f"[burst] 3 x render_burst({K}) against {3 * K} render() calls, "
        f"equal bit for bit: {same}; the replayed burst {ms:.2f} ms a "
        f"frame, replayed render() {seq_ms:.2f} ms a frame (frames "
        f"{2 * K + 1}-{3 * K}) on {nvidia_smi_line()}; capture ms "
        f"{ {k: round(v, 1) for k, v in bur.capture_ms.items()} }")
    return [] if all(same) else ["burst"]


def phase_overflow(dev):
    """The headline with its binning capacity fixed at 1,000 tile entries
    (it needs ~79,000): frames 1 and 2 run eagerly with exact lists; the
    first replay must raise before its commit, leaving the frame count
    and the history as they were. With the capacity no longer fixed, the
    same view must then render (its key captured again at a capacity
    sized from what it needed) and equal the eager renderer's frame, bit
    for bit."""
    import torch

    from hybridrenderer_tpu_torch.core.camera import OrbitCamera

    W, H = HEADLINE["width"], HEADLINE["height"]
    r, _, _ = _path_renderer(dev, _hybrid_settings(W, H), None, False)
    eager, _, _ = _path_renderer(dev, _hybrid_settings(W, H), None, False,
                                 capture=False)
    r.bin_capacity = 1000
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    states = [cam.step(taa_enabled=True) for _ in range(3)]
    for cs in states[:2]:
        r.render(cs)
        eager.render(cs)
    before = {k: v.clone() for k, v in r.state.history.items()}
    try:
        r.render(states[2])
    except RuntimeError as e:
        kept = r.frame_count == 2 and all(
            torch.equal(before[k], v) for k, v in r.state.history.items())
        log(f"[overflow] raised: {e}; frame count and history kept: {kept}")
        if not kept:
            return ["overflow state"]
    else:
        log("[overflow] FAILED: the overflowed frame rendered")
        return ["overflow"]
    r.bin_capacity = None
    same = torch.equal(r.render(states[2]), eager.render(states[2]))
    log(f"[overflow] the same view with the capacity per key: rendered at "
        f"capacity {r._graphs[('frame', True)].capacity}, equal to the "
        f"eager frame bit for bit: {same}")
    return [] if same else ["overflow recapture"]


def phase_cli_viewer(dev, out_dir):
    """The CLI renders --scene stress --path hybrid --frames 3 at
    1920x1080 on the card to PNGs (a process of its own); the viewer
    serves one /frame.png and one /input on localhost."""
    import threading
    import urllib.request

    from hybridrenderer_tpu_torch.app.main import default_camera
    from hybridrenderer_tpu_torch.app.viewer import Viewer, make_server
    from hybridrenderer_tpu_torch.runtime.output import read_png
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes

    failures = []
    out = os.path.join(out_dir, "chip_smoke_cli.png")
    cmd = [sys.executable, "-m", "hybridrenderer_tpu_torch.app.main",
           "--scene", "stress", "--path", "hybrid", "--frames", "3",
           "--width", "1920", "--height", "1080", "--out", out]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    shapes = []
    for i in range(3):
        png = out.replace(".png", f"_{i:03d}.png")
        img = read_png(png) if os.path.exists(png) else None
        shapes.append(None if img is None else (img.shape,
                                                round(float(img.std()), 1)))
    log(f"[cli] {' '.join(cmd[1:])}: exit {proc.returncode} in "
        f"{time.perf_counter() - t:.1f} s; {proc.stdout.strip()[-200:]}; "
        f"PNGs (shape, std) {shapes}")
    if proc.returncode != 0 or any(
            x is None or x[0] != (1080, 1920, 3) or x[1] <= 0 for x in shapes):
        log(f"[cli] FAILED: {proc.stderr[-2000:]}")
        failures.append("cli")

    settings = _hybrid_settings(256, 256)
    viewer = Viewer(Renderer.for_scene(settings, scenes.cube_scene().build(
        dev)), default_camera("cube", 256, 256))
    srv = make_server(viewer, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = "http://%s:%d" % srv.server_address
    try:
        with urllib.request.urlopen(url + "/frame.png", timeout=120) as resp:
            png = resp.read()
        req = urllib.request.Request(url + "/input", method="POST",
                                     data=json.dumps({"orbit": [0.2, 0.0]})
                                     .encode())
        with urllib.request.urlopen(req, timeout=120) as resp:
            state = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    ok = png[:8] == b"\x89PNG\r\n\x1a\n" and state.get("frame", 0) >= 1
    log(f"[viewer] /frame.png {len(png)} bytes, /input → {state}: "
        f"{'ok' if ok else 'FAILED'}")
    return failures + ([] if ok else ["viewer"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=tempfile.gettempdir(),
                    help="directory for the rendered PNGs")
    ap.add_argument("--find-big-scene", action="store_true",
                    help="only search the object count BIG_OBJECTS names")
    ap.add_argument("--k5-against", metavar="DIR",
                    help="only time K5 against K5 built from the tree in DIR")
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
    if args.find_big_scene:
        native.bvh_library()
        find_big_scene()
        return 0
    phase_build()
    if args.k5_against:
        k5_against(dev, os.path.abspath(args.k5_against))
        return 0
    # every check runs, so one call reports every failure; any failure
    # fails the script after the renders
    results, failures = {}, []
    for name, check in (("raster_tiles", check_raster),
                        ("raster_tiles_bf16", check_raster_bf16),
                        ("trace_any", check_trace),
                        ("trace_closest", check_trace_closest),
                        ("shade", check_shade),
                        ("packet_path", check_packet_path),
                        ("wide", check_wide),
                        ("temporal_fetch", check_temporal),
                        ("window_sample", check_window_sample),
                        ("taa", check_taa),
                        ("stencils", check_stencils)):
        try:
            res = check(dev)
        except AssertionError as e:
            log(f"[kernel] {name} FAILED: {e}")
            failures.append(name)
            continue
        results.update(res if name in ("packet_path", "wide", "stencils",
                                       "shade", "taa")
                       else {name: res})
    for name, res in results.items():
        off = "" if native.KERNELS[name].on_path else \
            " (checked only: no path launches it)"
        lib = res.get("library_ms")
        # device time where the check gives the eager calls' time beside it
        timer = (f"device time; eager calls {res['eager_ms']:.4f}"
                 if "eager_ms" in res else "eager calls")
        log(f"[kernel] {name}: max err {res['err']:.3g} ({res['tol']}); "
            f"{res['ms']:.4f} ms kernel ({timer}) vs {res['plain_ms']:.4f} "
            f"ms plain"
            + (f" vs {lib:.4f} ms library" if lib is not None else "")
            + (f" (eager {res['library_eager_ms']:.4f})"
               if "library_eager_ms" in res else "")
            + f"; bound {res['bound'][0]:.4f} ms ({res['bound'][1]}) "
            f"at {res['shape']}{off}")
    for name, check in (("sampler", check_sampler),
                        ("quantized", check_quantized_trace),
                        ("raster_window", check_raster_window),
                        ("temporal_window", check_temporal_window),
                        ("shadow_pair", check_shadow_pair)):
        try:
            check(dev)
        except AssertionError as e:
            log(f"[{name}] FAILED: {e}")
            failures.append(name)
    phase_golden(dev)
    from hybridrenderer_tpu_torch.core.types import RenderFlags
    from hybridrenderer_tpu_torch.scene import scene as scenes

    W, H = HEADLINE["width"], HEADLINE["height"]
    hybrid = ["raster_tiles", "trace_any", "temporal_fetch",
              "filter_moments", "atrous"]
    wide = dict(trace_backend="pallas-wide")
    direct = ["trace_any", "trace_closest", "trace_packet"]
    # radiance hits: one shading pair a radiance query
    shading = ["shade_hit", "shade_finish"]
    two_queries = {"shade_hit": 2, "shade_finish": 2}
    runs = {
        "headline": phase_render(dev, args.out, "headline",
                                 _hybrid_settings(W, H), hybrid),
        "full_graph": phase_render(
            dev, args.out, "full_graph", _hybrid_settings(
                W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI),
            hybrid + ["trace_closest"] + shading, per_frame=two_queries),
        "forward_taa": phase_render(dev, args.out, "forward_taa",
                                    _forward_settings(W, H),
                                    ["raster_tiles"] + TAA),
        "raytraced": phase_render(
            dev, args.out, "raytraced", _raytraced_settings(W, H),
            ["raster_tiles", "trace_closest", "trace_any"] + TAA + shading,
            absent=["raster_vis", "trace_packet"]),
        "raytraced_packet": phase_render(
            dev, args.out, "raytraced_packet", _raytraced_settings(
                W, H, raster_eval="v2", trace_backend="pallas"),
            ["raster_vis", "trace_packet"] + TAA + shading,
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
        hybrid + ["trace_closest"] + shading, host_fn=_textured_headline,
        per_frame=two_queries)
    runs["cutout"] = phase_render(
        dev, args.out, "cutout", _hybrid_settings(W, H),
        ["raster_tiles", "trace_closest", "temporal_fetch", "filter_moments",
         "atrous"], absent=["trace_any"], host_fn=scenes.cutout_scene,
        cam_kw=CUTOUT_CAM, per_frame={"raster_tiles": 2})
    runs["raytraced_cutout"] = phase_render(
        dev, args.out, "raytraced_cutout", _raytraced_settings(W, H),
        ["raster_tiles", "trace_closest"] + TAA + shading,
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
            ["raster_tiles", kernel] + TAA + shading,
            absent=direct + [other[kernel]])
    # the large-scene contract: bench.py's 1000-object rungs (S, S-tex,
    # S-fwd-tex) and the full graph and ray-traced path on the same scene
    # (F-1000, R-1000), whose radiance hits shade from the quantized rows;
    # R-w-big, the ray-traced path with wide_kernel "compressed" on the
    # smallest scene above the 96 MiB record budget, traced as the
    # reference does there (K2 / K2c over bf16 triangles, no K2w); and
    # H-a16, the headline with bf16 raster attributes
    def sponza():
        return scenes.stress_scene(num_objects=SPONZA_OBJECTS)

    def sponza_tex():
        return scenes.stress_scene(num_objects=SPONZA_OBJECTS, textured=True)

    def quantized_rows(r):
        if r.scene.shade_rows_q is None:
            raise AssertionError("the 1000-object scene does not shade "
                                 "from the quantized rows")

    def bf16_triangles(r):
        if not r.tracer.quantized or r.tracer.wide_kernel is not None:
            raise AssertionError("R-w-big's tracer is not K2 / K2c over "
                                 "bf16 triangles")

    rt = ["raster_tiles", "trace_closest", "trace_any"] + TAA + shading
    large = dict(frames=LARGE_FRAMES)
    runs["sponza"] = phase_render(dev, args.out, "sponza",
                                  _hybrid_settings(W, H), hybrid,
                                  host_fn=sponza, **large)
    runs["sponza_tex"] = phase_render(dev, args.out, "sponza_tex",
                                      _hybrid_settings(W, H), hybrid,
                                      host_fn=sponza_tex, **large)
    runs["sponza_fwd_tex"] = phase_render(
        dev, args.out, "sponza_fwd_tex", _forward_settings(W, H),
        ["raster_tiles"] + TAA, host_fn=sponza_tex, **large)
    runs["full_graph_1000"] = phase_render(
        dev, args.out, "full_graph_1000", _hybrid_settings(
            W, H, extra=RenderFlags.REFLECTION | RenderFlags.GI),
        hybrid + ["trace_closest"] + shading, host_fn=sponza,
        check=quantized_rows, per_frame=two_queries, **large)
    runs["raytraced_1000"] = phase_render(
        dev, args.out, "raytraced_1000", _raytraced_settings(W, H), rt,
        host_fn=sponza, check=quantized_rows, **large)
    runs["raytraced_wide_big"] = phase_render(
        dev, args.out, "raytraced_wide_big",
        _raytraced_settings(W, H, wide_kernel="compressed", **wide), rt,
        absent=["trace_wide", "trace_mimt"], host_fn=_big_scene,
        check=bf16_triangles, frames=BIG_FRAMES)
    runs["headline_a16"] = phase_render(
        dev, args.out, "headline_a16",
        _hybrid_settings(W, H, raster_attr_bits=16),
        ["raster_tiles_bf16"] + hybrid[1:], absent=["raster_tiles"])
    diff = np.abs(runs["headline_a16"][1] - runs["headline"][1])
    log(f"[headline_a16] last frame against the headline's (f32 "
        f"attributes): max abs diff {diff.max():.3g}, mean {diff.mean():.3g}")
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
    # the wide tree's shapes and the fused shadow + AO query
    failures += _wide_rungs(dev, args.out, runs)
    paths = {name: launches for name, (launches, *_) in runs.items()}
    # phase 6: the captured frame's own checks
    failures += phase_captured_vs_eager(dev)
    failures += phase_burst(dev)
    failures += phase_overflow(dev)
    failures += phase_cli_viewer(dev, args.out)
    # phase 7: the row-sharded frame
    sharded, sharded_failures = phase_sharded(dev, args.out)
    paths.update(sharded)
    failures += sharded_failures
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
            launches_per_path=per_path, shape=res["shape"],
            **{key: res[key] for key in ("eager_ms", "library_eager_ms")
               if key in res}))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
