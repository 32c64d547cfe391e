"""The benchmark's own arithmetic: the window's rate and tail, the
kernel counts from a frame's shape, the trace's idle share and gaps,
and the no-JAX check."""
import math

import pytest

from framebench import imports, profile, rooflines, spec, stats
from framebench.frame_shape import FrameShape

HYBRID = ["LIGHT", "IBL", "EMISSIVE", "SHADOW", "AO", "SVGF",
          "SVGF_TEMPORAL", "SVGF_SPATIAL"]


def test_rate_and_tail_over_a_window_with_a_stall():
    times = [14.0] * 99 + [250.0]          # one stall of 250 ms
    window_s = sum(times) / 1e3 + 0.05     # the host's time between frames
    assert stats.rate_ms(window_s, len(times)) == pytest.approx(
        (1386.0 + 250.0 + 50.0) / 100)
    assert stats.percentile(times, 95) == 14.0
    assert stats.percentile(times, 100) == 250.0
    five_stalls = [14.0] * 95 + [250.0] * 5
    assert stats.percentile(five_stalls, 95) == 14.0
    assert stats.percentile(five_stalls + [250.0], 95) == 250.0
    with pytest.raises(ValueError):
        stats.rate_ms(1.0, 0)


FORWARD = ["LIGHT", "IBL", "EMISSIVE", "SHADOW", "TAA"]


def _shape(extra=(), w=1920, h=1080, path="HYBRID", **settings):
    flags = HYBRID if path == "HYBRID" else FORWARD
    return FrameShape.of({"width": w, "height": h, "path": path,
                          "flags": flags + list(extra),
                          "settings": settings})


def _counts(s):
    return (s.any_hit_queries, s.radiance_queries, s.svgf_chains,
            s.taa_fetches)


def test_queries_and_chains_follow_the_flags():
    h, f = _shape(), _shape(["REFLECTION", "GI"])
    assert _counts(h) == (2, 0, 1, 0)
    assert _counts(f) == (4, 2, 3, 0)
    # the forward path: the sun's shadow query, TAA's history fetch; AO,
    # radiance rays and SVGF flags give it nothing, the hybrid path no TAA
    fwd = _shape(path="FORWARD")
    assert _counts(fwd) == (1, 0, 0, 1)
    assert _counts(_shape(["AO", "REFLECTION", "GI", "SVGF"],
                          path="FORWARD")) == (1, 0, 0, 1)
    assert _counts(_shape(["TAA"])) == (2, 0, 1, 0)
    with pytest.raises(ValueError):
        _shape(path="RAYTRACED")


def test_roofline_counts_from_shapes():
    r = spec.rooflines()
    px = 1920 * 1080
    h, f = _shape(svgf_bits=16), _shape(["REFLECTION", "GI"], svgf_bits=16)
    assert r["K1"].count(h) == (px * 16, 0)
    assert r["K2"].count(h) == (px * 2 * 25, 0)
    assert r["K2"].count(f) == (px * 4 * 25, 0)
    assert r["K2c"].count(h) == (0, 0)
    assert r["K2c"].count(f) == (px * 2 * 40, 0)
    assert r["K3"].count(h) == (px * 48, 0)
    assert r["K3"].count(_shape(svgf_bits=32)) == (px * 60, 0)
    assert r["K4m"].count(f) == (px * 60 * 3, px * 392 * 3)
    assert r["K4a"].count(h) == (px * 48 * 3, px * 200 * 3)


def test_k5_counts_the_forward_frame_and_no_hybrid_cell():
    r = spec.rooflines()
    px = 1920 * 1080
    fwd = _shape(path="FORWARD")
    # uv 8 B, three float32 history planes 12 B, the sample 12 B
    assert r["K5"].count(fwd) == (px * 32, 0)
    assert math.isclose(rooflines.bound_ms(_trace([], shape=fwd), "K5"),
                        0.0198, rel_tol=0.01)
    assert r["K2"].count(fwd) == (px * 25, 0)
    for name in ("K2c", "K3", "K4m", "K4a"):
        assert r[name].count(fwd) == (0, 0)
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        if cfg["render"]["path"] == "HYBRID":
            assert r["K5"].count(FrameShape.of(cfg["render"])) == (0, 0)


def _trace(ops, spans=(), start=0.0, end=1000.0, frames=1, devices=1,
           shape=None):
    return profile.Trace(
        ops=list(ops), spans=list(spans), start=start, end=end,
        frames=frames, kernel_names=frozenset({"trace_any_kernel"}),
        shape=shape or _shape(), counters={}, rooflines=spec.rooflines(),
        peaks=spec.peaks(), devices=devices)


def test_union_idle_and_gaps():
    ops = [("a", 0.0, 100.0, 0), ("b", 50.0, 150.0, 0),
           ("trace_any_kernel(x)", 400.0, 500.0, 0), ("c", 900.0, 1200.0, 0)]
    spans = [("frame", 0.0, 1000.0), ("render", 120.0, 450.0),
             ("synchronize", 600.0, 800.0)]
    t = _trace(ops, spans)
    assert profile.union([(s, e) for _, s, e, _ in ops], 0, 1000) == [
        [0.0, 150.0], [400.0, 500.0], [900.0, 1000.0]]
    assert profile.busy_us(t) == 350.0
    assert profile.busy_s_per_device(t) == pytest.approx(350e-6)
    gaps = profile.idle_gaps(t)
    assert gaps[0] == ["synchronize", pytest.approx(400e-6)]
    assert gaps[1] == ["render", pytest.approx(250e-6)]
    assert t.per_frame_ms(t.matching(["trace_any_kernel"])) == \
        pytest.approx(0.1)
    assert t.is_port_kernel("void trace_any_kernel<4>(float4 const*)")
    assert not t.is_port_kernel("void trace_any_kernel_v2(int)")
    assert spec.metric("device.idle_share")(t) == pytest.approx(0.65)
    # a sharded cell's split metrics read as the shared ones
    for name in ("device.idle_share", "kernels.device_ms", "ops.device_ms"):
        assert spec.metric(name + ".sharded")(t) == spec.metric(name)(t)


def test_a_device_not_traced_reads_nothing():
    t = _trace([("trace_any_kernel", 0.0, 10.0, 0)], devices=4)
    assert spec.metric("device.idle_share")(t) is None
    assert rooflines.share(t, "K2") is None
    assert spec.metric("kernels.device_ms")(t) is None


def test_traced_frames_tail_and_silence_without_frames():
    # twenty frame spans of 10..29 ms (host us), in no order
    spans = [("frame", 1e5 * k, 1e5 * k + 1e3 * (10 + (7 * k) % 20))
             for k in range(20)] + [("render", 0.0, 5e4)]
    p95 = spec.metric("parallel.frame_ms_p95")
    assert p95(_trace([], spans, devices=4)) == pytest.approx(28.0)
    assert p95(_trace([], [("render", 0.0, 5e4)])) is None


def test_roofline_share_of_a_kernel_and_silence_when_absent():
    # K2 at the hybrid frame's count, taking exactly twice its bound
    b = rooflines.bound_ms(_trace([]), "K2")
    t = _trace([("trace_any_kernel", 0.0, 2e3 * b, 0)], end=1e6)
    assert rooflines.share(t, "K2") == pytest.approx(50.0)
    assert rooflines.total_share(t) == pytest.approx(50.0)
    assert rooflines.share(t, "K1") is None
    assert math.isclose(b, 1e3 * 1920 * 1080 * 50 / 3.35e12)


def test_port_kernel_names_come_from_the_sources():
    names = profile.port_kernel_names(spec.ROOT)
    for mod in spec.rooflines().values():
        assert set(mod.NAMES) <= names


@pytest.mark.parametrize("names,found", [
    (["hybridrenderer_tpu_torch.ops", "hybridrenderer_tpu_torch"], []),
    (["hybridrenderer_tpu.ops"], ["hybridrenderer_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "numpy"], []),
])
def test_no_jax_check_compares_top_level_names_whole(names, found):
    assert imports.forbidden(names) == found


def test_the_harness_and_the_port_load_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); "
            "import framebench.harness, framebench.program, "
            "framebench.calibrate, framebench.reference.render, "
            "framebench.reference.forward; "
            "import hybridrenderer_tpu_torch.runtime.renderer, "
            "hybridrenderer_tpu_torch.scene.dynamic, "
            "hybridrenderer_tpu_torch.ops.trace; "
            "from framebench import imports; "
            "print(imports.loaded_forbidden())" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
