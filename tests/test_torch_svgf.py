"""Port vs reference: SVGF — the plain versions of K3 (temporal history
fetch) and K4 (filter_moments, variance_blur, atrous), and the chain.

K3 is held to the reference's exact per-pixel fetch
(svgf.temporal_multi, gather="pixel"); K4 to the Pallas stencils in
interpret mode, called as tests/test_stencil_pallas.py calls them; the
chain to svgf.denoise_multi with backend "jnp" and gather "pixel"."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import stencil_pallas
from hybridrenderer_tpu.ops import svgf as ref_svgf
from hybridrenderer_tpu_torch.ops import stencil_cuda, svgf

from .torch_parity import clear_reference_knobs, one_torch_thread

PHI = (4.0, 128.0, 0.02, 0.0)
PHI_F32 = tuple(float(x) for x in np.asarray(PHI, np.float32))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    clear_reference_knobs(monkeypatch)
    with one_torch_thread():
        yield


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16(a):
    """float32 array rounded to bfloat16 (round to nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _frame(seed, H=24, W=40):
    """Seeded frame planes: smooth depth and normals, a few object ids,
    some background, sub-pixel motion, and a history whose moments are
    consistent (m2 >= m1^2) so the variance is not rounding noise."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = (4.0 + yy * 0.2 + 0.05 * g.random((H, W))).astype(np.float32)
    oid = ((xx // 13) % 3).astype(np.int32)
    bg = g.random((H, W)) < 0.08
    depth[bg] = 0.0
    oid[bg] = -1
    nrm = np.stack([0.2 * g.standard_normal((H, W)), np.ones((H, W)),
                    0.2 * g.standard_normal((H, W))], -1).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mp = np.stack([(0.3 + 0.5 * g.random((H, W))) / W,
                   (0.2 * g.standard_normal((H, W))) / H, depth,
                   0.05 * g.random((H, W))], -1).astype(np.float32)
    sig = (0.2 + 0.6 * g.random((H, W, 4))).astype(np.float32)
    hsig = (0.2 + 0.6 * g.random((H, W, 4))).astype(np.float32)
    m1 = (0.2 + 0.6 * g.random((H, W))).astype(np.float32)
    var = (0.01 + 0.05 * g.random((H, W))).astype(np.float32)
    hlen = g.integers(1, 12, (H, W)).astype(np.float32)
    hmom = np.stack([m1, m1 * m1 + var, var, hlen], -1).astype(np.float32)
    prev_depth = (depth * (1.0 + 0.01 * g.standard_normal((H, W)))).astype(
        np.float32)
    albedo = (0.1 + 0.8 * g.random((H, W, 3))).astype(np.float32)
    return dict(sig=sig, hsig=hsig, hmom=hmom, mp=mp, nrm=nrm, oid=oid,
                prev_depth=prev_depth, albedo=albedo)


@pytest.mark.parametrize("bits", [32, 16])
@pytest.mark.parametrize("demod", [False, True])
def test_temporal_matches_pixel_gather(bits, demod):
    f = _frame(1)
    hsig, hmom = f["hsig"], f["hmom"]
    if bits == 16:   # the stored history is bf16; both read the same values
        hsig = _bf16(hsig).float().numpy()
        hmom = _bf16(hmom).float().numpy()
    ref_hist = ref_svgf.SVGFSignalHistory(signal=jnp.asarray(hsig),
                                          moments=jnp.asarray(hmom))
    ((r_acc, r_mom),) = ref_svgf.temporal_multi(
        [jnp.asarray(f["sig"])], jnp.asarray(f["albedo"]),
        jnp.asarray(f["mp"]), jnp.asarray(f["nrm"]), jnp.asarray(f["oid"]),
        [ref_hist], jnp.asarray(f["nrm"]), jnp.asarray(f["prev_depth"]),
        jnp.asarray(f["oid"]), [demod], True, gather="pixel", bits=bits)
    store = _bf16 if bits == 16 else _t
    hist = svgf.SVGFSignalHistory(signal=store(f["hsig"]),
                                  moments=store(f["hmom"]))
    acc, mom = svgf.temporal(
        _t(f["sig"]), _t(f["albedo"]), _t(f["mp"]), _t(f["nrm"]),
        _t(f["oid"]), hist, _t(f["nrm"]), _t(f["prev_depth"]), _t(f["oid"]),
        demod, True)
    valid = np.asarray(r_mom)[..., 3] > 1.0
    assert 0.3 < valid.mean() < 1.0
    np.testing.assert_allclose(acc.numpy(), np.asarray(r_acc), atol=1e-4)
    np.testing.assert_allclose(mom.numpy(), np.asarray(r_mom), atol=1e-4)


def _stencil_inputs(seed, H=24, W=200):
    """The inputs of tests/test_stencil_pallas.py."""
    rng = np.random.default_rng(seed)
    sig = rng.random((H, W, 4), dtype=np.float32)
    mp = rng.random((H, W, 4), dtype=np.float32) + 0.5
    nrm = rng.random((H, W, 3), dtype=np.float32)
    mom = rng.random((H, W, 4), dtype=np.float32) + 0.5
    return sig, mp, nrm, mom


@pytest.mark.parametrize("step", [1, 2, 4])
def test_atrous_matches_pallas(step):
    sig, mp, nrm, _ = _stencil_inputs(0)
    mp[3:7, 20:60, 2] = 0.0          # background passthrough
    ref = stencil_pallas.atrous(jnp.asarray(sig), jnp.asarray(nrm),
                                jnp.asarray(mp), step, jnp.asarray(PHI),
                                interpret=True)
    out = stencil_cuda.atrous(_t(sig), _t(nrm), _t(mp), step, PHI_F32[1],
                              PHI_F32[2])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_filter_moments_matches_pallas():
    sig, mp, nrm, mom = _stencil_inputs(1)
    mp[3:7, 20:60, 2] = 0.0
    mom[..., 3] = np.floor(mom[..., 3] * 4)   # history lengths 2..5
    r_sig, r_mom = stencil_pallas.filter_moments(
        jnp.asarray(sig), jnp.asarray(mom), jnp.asarray(nrm),
        jnp.asarray(mp), jnp.asarray(PHI), interpret=True)
    o_sig, o_mom = stencil_cuda.filter_moments(
        _t(sig), _t(mom), _t(nrm), _t(mp), PHI_F32[0], PHI_F32[2])
    np.testing.assert_allclose(o_sig.numpy(), np.asarray(r_sig), atol=2e-5)
    np.testing.assert_allclose(o_mom.numpy(), np.asarray(r_mom), atol=2e-5)


def test_variance_blur_matches_pallas():
    _, _, _, mom = _stencil_inputs(2)
    ref = stencil_pallas.variance_blur(jnp.asarray(mom), interpret=True)
    out = stencil_cuda.variance_blur(_t(mom))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("bits", [32, 16])
def test_denoise_chain_matches_reference(bits):
    """temporal → filter_moments → 3 à-trous steps → history at the
    configured width (the reference's variance_blur output feeds
    nothing, so the port skips it). The output to 1e-4; stored bf16
    history to one bf16 ulp."""
    f = _frame(3)
    cfg = ref_svgf.SVGFConfig(prefix="S", atrous_iterations=3, bits=bits,
                              backend="jnp", temporal_gather="pixel")
    ref_hist = ref_svgf.SVGFSignalHistory(signal=jnp.asarray(f["hsig"]),
                                          moments=jnp.asarray(f["hmom"]))
    ((r_out, r_hist, r_var),) = ref_svgf.denoise_multi(
        [jnp.asarray(f["sig"])], jnp.asarray(f["albedo"]),
        jnp.asarray(f["mp"]), jnp.asarray(f["nrm"]), jnp.asarray(f["oid"]),
        [ref_hist], jnp.asarray(f["nrm"]), jnp.asarray(f["prev_depth"]),
        jnp.asarray(f["oid"]), [cfg], jnp.asarray(PHI), history_valid=True)
    hist = svgf.SVGFSignalHistory(signal=_t(f["hsig"]),
                                  moments=_t(f["hmom"]))
    ((out, new_hist, var),) = svgf.denoise_multi(
        [_t(f["sig"])], _t(f["albedo"]), _t(f["mp"]), _t(f["nrm"]),
        _t(f["oid"]), [hist], _t(f["nrm"]), _t(f["prev_depth"]),
        _t(f["oid"]), [svgf.SVGFConfig(prefix="S", bits=bits)], PHI,
        history_valid=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(r_var), atol=1e-4)
    want = torch.bfloat16 if bits == 16 else torch.float32
    for name in ("signal", "moments"):
        got = getattr(new_hist, name)
        assert got.dtype == want
        ref = np.asarray(getattr(r_hist, name).astype(jnp.float32))
        rtol = 2.0**-7 if bits == 16 else 1e-5
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol,
                                   atol=1e-4, err_msg=name)
