"""How ``correct`` is decided: the program's frames against the
reference's, frame by frame, as numbers each held to a limit of its
own (limits/<cell>.json).

A frame is a dict of planes (H, W, ...): ``image``, the (H, W, 3)
float32 frame; ``object_id``, the object each pixel shows (-1: none);
``normal``, its world normal; ``depth``, its linear depth; and for each
SVGF chain (``shadow_ao``, ``reflection``, ``gi``) the first moment of
the luminance it accumulated over time, which the chain carries to the
next frame: of the raw shadow and AO signal, and of the reflection and
GI radiance over albedo. The program's planes other than the image are
the history its renderer carries (``Renderer.state``).

The SVGF filters weigh neighbours by their depth difference over a
depth gradient that can be nought, so a last-place difference in a
pixel's depth can change which neighbours it averages; the reference's
filters therefore weigh neighbours by the program's depth, normal and
object planes (render.py), which the numbers below hold to the
reference's own. The image is judged by its mean difference, the
layers under it pixel by pixel. Each number is its worst frame's."""
from __future__ import annotations

import math

import torch



def _quantile(x, q: float) -> float:
    x = x.flatten().float()
    if x.numel() == 0:
        return 0.0
    return float(x.kthvalue(max(1, int(math.ceil(q * x.numel())))).values)


def object_mismatch(p, r):
    """The share of pixels that show another object (or none)."""
    return float((p["object_id"] != r["object_id"]).float().mean())


def _same(p, r):
    return (p["object_id"] == r["object_id"]) & (r["object_id"] >= 0)


def depth_p999(p, r):
    """99.9th percentile, over pixels that show the same object, of the
    relative difference of their linear depths."""
    s = _same(p, r)
    return _quantile(((p["depth"] - r["depth"]).abs()
                      / r["depth"].clamp(min=1e-6))[s], 0.999)


def shadow_ao_mismatch(p, r):
    """The share of pixels whose accumulated shadow + AO luminance is
    off by more than 0.05 (a ray's verdict weighs 0.21 or 0.72)."""
    return float(((p["shadow_ao"] - r["shadow_ao"]).abs() > 0.05)
                 .float().mean())


def radiance_p99(p, r):
    """99th percentile, over pixels that show the same object, of the
    relative difference of the reflection's and the GI's accumulated
    luminance; the larger of the two."""
    s = _same(p, r)
    out = 0.0
    for c in ("reflection", "gi"):
        d = (p[c] - r[c]).abs() / (r[c].abs() + 0.05)
        out = max(out, _quantile(d[s], 0.99))
    return out


def image_mean_abs(p, r):
    """The mean over pixels of the largest channel's difference."""
    return float((p["image"] - r["image"]).abs().amax(-1).mean())


NUMBERS = {f.__name__: f for f in (object_mismatch, depth_p999,
                                   shadow_ao_mismatch, radiance_p99,
                                   image_mean_abs)}


def applicable(frame) -> list:
    """The numbers a frame's planes allow."""
    return [k for k in NUMBERS if k != "radiance_p99"
            or all(c in frame for c in ("reflection", "gi"))]


def readings(program_frames, reference_frames, names) -> dict:
    """Each of ``names``' worst frame; infinite where the frames do not
    pair up, differ in shape or the program's image is not finite."""
    if len(program_frames) != len(reference_frames):
        return {k: math.inf for k in names}
    out = {k: 0.0 for k in names}
    for p, r in zip(program_frames, reference_frames):
        r = {k: v.to(p["image"].device) for k, v in r.items()}
        if p["image"].shape != r["image"].shape \
                or not bool(torch.isfinite(p["image"]).all()):
            return {k: math.inf for k in names}
        for k in names:
            out[k] = max(out[k], NUMBERS[k](p, r))
    return out


def judge(read: dict, limits: dict) -> tuple:
    """→ (correct, {name: {"value", "limit"}}) over the limits' numbers."""
    checks = {k: {"value": read[k], "limit": float(limits[k])}
              for k in limits}
    if not checks:
        raise ValueError("the limits name no compared number")
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
