#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases (a failed kernel check is reported and the renders still run,
so one run shows every failure; any failure makes the script exit
non-zero without printing a result):

1. environment: torch, CUDA, nvcc and the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a) and the native BVH builder
   (g++), from the sources in this checkout;
3. kernels: each kernel against its plain PyTorch version on the card,
   with the tolerance stated, timed with CUDA events;
4. golden: the tests/goldens/cube_hybrid_128.png case rendered on the
   card, held to the golden off triangle edges;
5. headline: the hybrid frame of bench.py (stress scene, 250 objects,
   1920x1080, shadow + AO + SVGF) for 8 frames, with the launch count
   of every kernel the frame runs and a check that no plain version ran
   on the card. variance_blur is checked in phase 3 but not launched by
   the frame: its output feeds nothing (ops/svgf.py).

The last three lines of standard output are the kernels' JSON record,
the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Float32 throughout; TF32 is off for
matmul and cuDNN. The headline image is written to DIR (default: the
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


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    t2 = time.perf_counter()
    log(f"[build] kernels {t1 - t0:.1f} s, bvh {t2 - t1:.1f} s")
    with open(native.kernel_library_path() + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("[build] " + line.strip())


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


def check_raster(dev):
    from hybridrenderer_tpu_torch.ops import raster_cuda as rc

    W, H = HEADLINE["width"], HEADLINE["height"]
    data = _headline_scene(dev, HEADLINE["objects"])
    rec, bbox, valid = rc.pack_candidates(_clipped(data, W, H, HEADLINE_CAM))
    ts, ec = rc.bin_candidates(bbox, valid, W, H)
    args = (rec, ts, ec, data.raster_rows, W, H)
    vk, ak = rc.raster_tiles(*args)
    vp, ap = rc.raster_tiles_plain(*args)
    same = vk.tri_id == vp.tri_id
    mismatch = 1.0 - same.float().mean().item()
    err = max((a - b).abs()[same].max().item() for a, b in (
        (vk.depth, vp.depth), (vk.bary1, vp.bary1), (vk.bary2, vp.bary2),
        (ak, ap)))
    # same float operations in the same order (-fmad=false): exact
    if mismatch > 0.0 or err > 0.0:
        raise AssertionError(f"K1 disagrees with its plain version: "
                             f"{mismatch:.2e} of pixels, max err {err}")
    ms = cuda_time(lambda: rc.raster_tiles(*args), 20)
    plain_ms = cuda_time(lambda: rc.raster_tiles_plain(*args), 2)
    return dict(err=err, ms=ms, plain_ms=plain_ms,
                shape=f"{W}x{H}, {ec.shape[0]} tile entries, "
                      f"{rec.shape[0]} candidates",
                tol="exact (tri ids and all outputs)")


def check_trace(dev):
    """K2 on the rays of one headline frame: RTShadowPass's shadow query
    (tmax 10000) and AO query (tmax 10), 2 x 1920*1080 rays, recorded as
    the renderer hands them to the tracer."""
    import torch

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
    if len(batches) != 2:
        raise AssertionError(f"expected the shadow and AO queries, got "
                             f"{len(batches)}")
    kern = lambda: [trace_cuda.intersect_any(tracer.packed, o, d, TMIN, t, a)
                    for o, d, t, a in batches]
    plain = lambda: [trace_cuda.intersect_any_plain(tracer.packed, o, d, TMIN,
                                                    t, a)
                     for o, d, t, a in batches]
    tks, tps = kern(), plain()
    mismatch, hit = [], []
    for (o, d, t, a), tk, tp in zip(batches, tks, tps):
        mismatch.append(((tk >= 0) != (tp >= 0)).float().mean().item())
        hit.append((tp >= 0)[a].float().mean().item())
    # both take the same path through the tree with the same arithmetic,
    # so even the reported triangle agrees; 0.1% slack for grazing rays
    if max(mismatch) > 1e-3:
        raise AssertionError(f"K2 visibility mismatch (shadow, AO) "
                             f"{mismatch}")
    nodes = tracer.packed.nodes
    depth = trace_cuda.tree_depth(nodes[:, 3].contiguous().view(torch.int32),
                                  nodes[:, 7].contiguous().view(torch.int32))
    R = batches[0][0].shape[0]
    active = [int(a.sum()) for *_, a in batches]
    return dict(err=max(mismatch), ms=cuda_time(kern, 20),
                plain_ms=cuda_time(plain, 1),
                shape=f"2 queries (shadow tmax 10000, AO tmax 10) of {R} rays "
                      f"of one {W}x{H} headline frame, {active} active, "
                      f"{data.num_triangles} triangles, tree depth {depth}, "
                      f"hit shadow {hit[0]:.3f} AO {hit[1]:.3f}; ms for both",
                tol="visibility mismatch <= 1e-3 of rays per query")


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
    return dict(err=err, ms=ms, plain_ms=plain_ms,
                shape=f"{W}x{H}, bf16 history, {valid:.3f} valid",
                tol="1e-5 abs")


def check_stencils(dev):
    import torch

    from hybridrenderer_tpu_torch.ops import stencil_cuda as sc

    H, W = HEADLINE["height"], HEADLINE["width"]
    depth, oid, nrm, mp, g = _frame_planes(dev, H, W, 2)
    sig = torch.from_numpy(g.random((H, W, 4)).astype(np.float32)).to(dev)
    mom = torch.from_numpy((g.random((H, W, 4)) * [1, 1, 1, 8]).astype(
        np.float32)).to(dev)
    phi_l, phi_a, phi_n = 4.0, 128.0, float(np.float32(0.02))
    cases = {
        "filter_moments": (lambda: sc.filter_moments(sig, mom, nrm, mp,
                                                     phi_l, phi_n),
                           lambda: sc.filter_moments_plain(sig, mom, nrm, mp,
                                                           phi_l, phi_n)),
        "variance_blur": (lambda: sc.variance_blur(mom),
                          lambda: sc.variance_blur_plain(mom)),
        "atrous": (lambda: [sc.atrous(sig, nrm, mp, s, phi_a, phi_n)
                            for s in (1, 2, 4)],
                   lambda: [sc.atrous_plain(sig, nrm, mp, s, phi_a, phi_n)
                            for s in (1, 2, 4)]),
    }
    out = {}
    for name, (kern, plain) in cases.items():
        ks, ps = kern(), plain()
        ks = ks if isinstance(ks, (list, tuple)) else [ks]
        ps = ps if isinstance(ps, (list, tuple)) else [ps]
        # exp and pow differ in the last ulp between CUDA and PyTorch;
        # outputs are normalized weighted means and variances
        err = max(((a - b).abs() / (1.0 + b.abs())).max().item()
                  for a, b in zip(ks, ps))
        if err > 1e-4:
            raise AssertionError(f"K4 {name} max rel err {err}")
        reps = 3 if name == "atrous" else 1
        out[name] = dict(
            err=err, ms=cuda_time(kern, 20) / reps,
            plain_ms=cuda_time(plain, 2) / reps,
            shape=f"{W}x{H}" + (", per step (1, 2, 4)" if reps > 1 else ""),
            tol="1e-4 relative to 1 + |plain|")
    return out


# ---------------------------------------------------------------------------
# phase 4-5: renders
# ---------------------------------------------------------------------------

def _hybrid_settings(width, height, **kw):
    from hybridrenderer_tpu_torch.core.config import RenderSettings
    from hybridrenderer_tpu_torch.core.types import RenderFlags, RenderPathType

    flags = (RenderFlags.LIGHT | RenderFlags.IBL | RenderFlags.EMISSIVE
             | RenderFlags.SHADOW | RenderFlags.AO | RenderFlags.SVGF
             | RenderFlags.SVGF_TEMPORAL | RenderFlags.SVGF_SPATIAL)
    return RenderSettings(width=width, height=height,
                          path=RenderPathType.HYBRID, flags=flags, **kw)


def phase_golden(dev):
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.ops import raster_cuda
    from hybridrenderer_tpu_torch.ops.image import tri_boundary_mask
    from hybridrenderer_tpu_torch.runtime.output import read_png, to_u8
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer
    from hybridrenderer_tpu_torch.scene import scene as scenes

    S = 128
    data = scenes.cube_scene().build(dev)
    r = Renderer.for_scene(_hybrid_settings(S, S, ao_block=8), data)
    cam = OrbitCamera(width=S, height=S, **GOLDEN_CAM)
    for _ in range(2):
        img = to_u8(r.render_np(cam.step()))
    golden = read_png(os.path.join(ROOT, "tests", "goldens",
                                   "cube_hybrid_128.png"))
    vis, _ = raster_cuda.rasterize_binned(
        _clipped(data, S, S, GOLDEN_CAM), S, S, data.raster_rows)
    diff = np.abs(img.astype(int) - golden.astype(int))
    err = diff.max(axis=-1)
    off = err[~tri_boundary_mask(vis.tri_id.cpu().numpy(), dilate=1)]
    off_max, p99 = int(off.max()), float(np.percentile(diff, 99))
    log(f"[golden] cube_hybrid_128: off-edge max {off_max} u8 "
        f"(gate {GOLDEN_OFF_EDGE_MAX}), p99 {p99} (gate {GOLDEN_P99_MAX}), "
        f"max {int(diff.max())}, mean {diff.mean():.4f}")
    if off_max > GOLDEN_OFF_EDGE_MAX or p99 > GOLDEN_P99_MAX:
        raise AssertionError("golden gate failed")


def phase_headline(dev, out_dir):
    import torch

    from hybridrenderer_tpu_torch import native
    from hybridrenderer_tpu_torch.core.camera import OrbitCamera
    from hybridrenderer_tpu_torch.runtime.output import write_png
    from hybridrenderer_tpu_torch.runtime.renderer import Renderer

    W, H, F = HEADLINE["width"], HEADLINE["height"], HEADLINE["frames"]
    data = _headline_scene(dev, HEADLINE["objects"])
    t0 = time.perf_counter()
    r = Renderer.for_scene(_hybrid_settings(W, H), data)
    log(f"[headline] {data.num_triangles} triangles; BVH build + renderer "
        f"{time.perf_counter() - t0:.2f} s")
    cam = OrbitCamera(width=W, height=H, **HEADLINE_CAM)
    native.reset_counts()
    times = []
    for _ in range(F):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = r.render(cam.step(taa_enabled=True))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        cam.orbit(0.01, 0.0)
    launches = {k.name: k.launches for k in native.KERNELS.values()
                if k.on_path}
    plain = {k.name: k.plain_cuda_calls for k in native.KERNELS.values()}
    stats = r.frame_stats()
    img = out.cpu().numpy()
    if img.shape != (H, W, 3) or not np.isfinite(img).all():
        raise AssertionError(f"headline output {img.shape} not finite")
    if img.max() <= 0.0 or stats["covered_pixels"] <= 0:
        raise AssertionError(f"headline frame black or empty: {stats}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the card: {plain}")
    png = os.path.join(out_dir, "chip_smoke_headline.png")
    write_png(png, np.clip(img, 0.0, 1.0))
    med = float(np.median(times[2:]))
    log(f"[headline] ms/frame per frame: {[round(t, 2) for t in times]}")
    log(f"[headline] median ms/frame (frames 3-{F}) {med:.2f} on "
        f"{nvidia_smi_line()}; covered {stats['covered_pixels']}; "
        f"launches {launches}; image {png}")
    return launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=tempfile.gettempdir(),
                    help="directory for the headline PNG")
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
                        ("temporal_fetch", check_temporal),
                        ("stencils", check_stencils)):
        try:
            res = check(dev)
        except AssertionError as e:
            log(f"[kernel] {name} FAILED: {e}")
            failures.append(name)
            continue
        results.update(res if name == "stencils" else {name: res})
    for name, res in results.items():
        off = "" if native.KERNELS[name].on_path else \
            " (checked only: the frame does not launch it)"
        log(f"[kernel] {name}: max err {res['err']:.3g} ({res['tol']}); "
            f"{res['ms']:.4f} ms kernel vs {res['plain_ms']:.4f} ms plain "
            f"at {res['shape']}{off}")
    phase_golden(dev)
    launches = phase_headline(dev, args.out)
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")

    kernels = []
    for name, res in results.items():
        k = native.KERNELS[name]
        if not k.on_path:
            continue
        kernels.append(dict(name=name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[name],
                            max_abs_err=res["err"], ms=res["ms"],
                            plain_ms=res["plain_ms"], shape=res["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
