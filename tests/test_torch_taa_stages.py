"""The staged TAA resolve (ops/taa_cuda.py: reproject, the K5 history
fetch, resolve) against the unsplit resolve it replaced, bit for bit, on
the CPU: the whole image, a row window with one halo row, no valid
history, reprojection off every edge, non-finite and negative colour, a
strided motion slice as the ray-traced path passes, and a size that cuts
the kernels' tiles."""
import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.ops import taa, taa_cuda

from .torch_taa_cases import CASES, build, unsplit_resolve


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_resolve_equals_unsplit(case):
    args, kw = build(case, "cpu")
    cur, hist, motion, depth, jitter, prev_j = args
    FH = hist.shape[0]
    prev_uv, alpha = taa_cuda.taa_reproject_plain(
        motion, depth, jitter, prev_j, kw["history_valid"], kw["row0"], FH)
    sample = taa.window_sample(hist, prev_uv)
    staged = taa_cuda.taa_resolve_plain(cur, sample, alpha)
    want = unsplit_resolve(*args, **kw)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(staged, want, rtol=0, atol=0)
    torch.testing.assert_close(taa.resolve(*args, **kw), want, rtol=0,
                               atol=0)
    off = ((prev_uv < 0.0) | (prev_uv > 1.0)).any(-1)
    if not kw["history_valid"]:
        assert (alpha == 1.0).all()
    else:
        assert 0 < (alpha < 1.0).float().mean() <= 1.0
        assert (alpha[off] == 1.0).all()
    if case == "off_screen":
        assert off[:, 0].all() and off[:, -1].all() and off[0].all() \
            and off[-1].all()
    # no stage ran as a plain version on a card
    assert not any(native.KERNELS[k].plain_cuda_calls
                   for k in ("taa_reproject", "taa_resolve"))


def test_resolve_fetches_history_through_the_module(monkeypatch):
    """resolve fetches its history once through ``taa.window_sample`` (the
    name recorders and planted faults replace) at the reprojected uv."""
    args, kw = build("whole", "cpu")
    calls = []

    def recording(image, uv):
        calls.append(uv)
        return image

    monkeypatch.setattr(taa, "window_sample", recording)
    taa.resolve(*args, **kw)
    prev_uv, _ = taa_cuda.taa_reproject(args[2], args[3], args[4], args[5],
                                        kw["history_valid"], kw["row0"],
                                        args[1].shape[0])
    assert len(calls) == 1 and torch.equal(calls[0], prev_uv)


def test_disabled_resolve_returns_the_colour():
    args, kw = build("whole", "cpu")
    assert taa.resolve(*args, enabled=False, **kw) is args[0]
