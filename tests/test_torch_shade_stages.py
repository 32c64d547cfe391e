"""The staged hit shading (ops/shade_cuda.py: prepare, the occlusion
query, finish) against the unsplit shading it replaced, bit for bit, on
the CPU: quantized rows, four texture slots with the normal map, NEE
over an emissive quad in a row window, an equirect sky texture, IBL
off, LIGHT off, a tile-order (pallas-wide) tracer and a cut-out scene,
each with inactive rays and rays that miss."""
import pytest
import torch

from hybridrenderer_tpu_torch import native
from hybridrenderer_tpu_torch.ops import shade_cuda

from .torch_shade_cases import CASES, build, unsplit_trace_radiance


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_shading_equals_unsplit(case):
    tracer, data, ctx, o, d, a, row0 = build(case, "cpu")
    rgb, dist = tracer.trace_radiance(data, o, d, ctx, 0, active=a,
                                      row0=row0)
    want_rgb, want_dist = unsplit_trace_radiance(tracer, data, o, d, ctx,
                                                 active=a, row0=row0)
    hit = dist > 0
    assert 0.3 < hit.float().mean() < 1.0 and (~hit & a).any()
    assert rgb[hit].abs().max() > 0.0
    torch.testing.assert_close(rgb, want_rgb, rtol=0, atol=0)
    torch.testing.assert_close(dist, want_dist, rtol=0, atol=0)
    # no stage ran as a plain version on a card
    assert not any(native.KERNELS[k].plain_cuda_calls
                   for k in ("shade_hit", "shade_finish"))


@pytest.mark.parametrize("case", ["cornell_nee_row0", "tile_order"])
def test_prepare_zeroes_rays_that_miss(case):
    """At rays that hit nothing the prepare stage writes zeros and no
    active occlusion ray; the finish gives them the sky and -1."""
    tracer, data, ctx, o, d, a, row0 = build(case, "cpu")
    h = tracer.radiance_hits(o, d, a)
    prep = shade_cuda.shade_hit_prepare(tracer.shade_rows, data, h.o, h.d,
                                        h.t, h.tri, h.u, h.v, h.hit, ctx,
                                        h.fwd, row0 * h.lead[1])
    miss = ~h.hit
    assert miss.any() and h.hit.any()
    assert (prep.terms[miss] == 0).all()
    K = prep.occ_o.shape[0] // h.o.shape[0]
    assert K == 1 + (data.lights.count > 0)
    assert not prep.occ_act.reshape(K, -1)[:, miss].any()
    assert (prep.occ_o.reshape(K, -1, 3)[:, miss] == 0).all()


