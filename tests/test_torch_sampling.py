"""Port vs reference: the sampling module's integer RNG and bitcasts
(hybridrenderer_tpu_torch/ops/sampling.py against
hybridrenderer_tpu/ops/sampling.py). Same numpy-seeded inputs to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridrenderer_tpu.ops import sampling as ref
from hybridrenderer_tpu.scene import scene as ref_scenes
from hybridrenderer_tpu_torch.ops import sampling as port
from hybridrenderer_tpu_torch.scene.convert import scene_from_numpy

from .torch_parity import flatten

RNG = np.random.default_rng(1234)
U32 = RNG.integers(0, 2**32, size=(2, 4096), dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_tea_seed_bit_exact():
    for frame in (0, 1, 7, 2**31 + 5):
        r = np.asarray(ref.init_random_seed(jnp.asarray(U32[0]),
                                            jnp.uint32(frame)))
        p = port.init_random_seed(_t(U32[0].astype(np.int64)), frame)
        np.testing.assert_array_equal(p.numpy(), r.astype(np.int64))
    r = np.asarray(ref.init_random_seed(jnp.asarray(U32[0]),
                                        jnp.asarray(U32[1])))
    p = port.init_random_seed(_t(U32[0].astype(np.int64)),
                              _t(U32[1].astype(np.int64)))
    np.testing.assert_array_equal(p.numpy(), r.astype(np.int64))


def test_random_float_stream_bit_exact():
    r_seed = jnp.asarray(U32[0])
    p_seed = _t(U32[0].astype(np.int64))
    for _ in range(6):
        r_val, r_seed = ref.random_float(r_seed)
        p_val, p_seed = port.random_float(p_seed)
        np.testing.assert_array_equal(p_val.numpy(), np.asarray(r_val))
        np.testing.assert_array_equal(p_seed.numpy(),
                                      np.asarray(r_seed).astype(np.int64))


def test_offset_ray_bit_exact():
    g = np.random.default_rng(5)
    scale = g.choice([1e-3, 0.02, 1.0, 37.0, 1e4], size=(8192, 1))
    p = (g.standard_normal((8192, 3)) * scale).astype(np.float32)
    n = g.standard_normal((8192, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    r = np.asarray(ref.offset_ray(jnp.asarray(p), jnp.asarray(n)))
    np.testing.assert_array_equal(port.offset_ray(_t(p), _t(n)).numpy(), r)


@pytest.mark.parametrize("block", [8, 128])
def test_interleaved_directions(block):
    """The per-pattern uniforms are bit-exact. The directions built from
    them go through sqrt, sin and cos, whose last-ulp rounding differs
    between XLA's CPU backend and PyTorch's for a few percent of inputs,
    so directions are held to 4 float32 ulps of a unit vector."""
    salt, frame = 0x51AB7000, 11
    pat = np.arange(16, dtype=np.uint32)
    r1, s = ref.random_float(ref.init_random_seed(jnp.asarray(pat + salt),
                                                  jnp.uint32(frame)))
    r2, _ = ref.random_float(s)
    q1, s = port.random_float(port.init_random_seed(
        _t((pat + salt).astype(np.int64)), frame))
    q2, _ = port.random_float(s)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(r1))
    np.testing.assert_array_equal(q2.numpy(), np.asarray(r2))

    g = np.random.default_rng(9)
    nrm = g.standard_normal((40, 72, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    r = np.asarray(ref.interleaved_cos_hemisphere(frame, jnp.asarray(nrm),
                                                  block=block))
    p = port.interleaved_cos_hemisphere(frame, _t(nrm), block=block).numpy()
    np.testing.assert_allclose(p, r, rtol=0, atol=4 * 2.0**-24)


def test_cos_hemisphere_and_blue_noise():
    g = np.random.default_rng(3)
    nrm = g.standard_normal((16, 20, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    seeds = U32[0, :320].reshape(16, 20)
    rd, rs = ref.cos_hemisphere_sample(jnp.asarray(seeds), jnp.asarray(nrm))
    pd, ps = port.cos_hemisphere_sample(_t(seeds.astype(np.int64)), _t(nrm))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs).astype(np.int64))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), atol=4 * 2.0**-24)
    bn = g.random((64, 64, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port.blue_noise_uniforms(_t(bn), 5, 30, 70).numpy(),
        np.asarray(ref.blue_noise_uniforms(jnp.asarray(bn), 5, 30, 70)))


def test_sample_lights_cornell():
    """Light CDF sampling on the cornell box (one emissive quad)."""
    data = ref_scenes.cornell_scene().build()
    tdata = scene_from_numpy(flatten(data), "cpu")
    g = np.random.default_rng(4)
    pos = g.uniform([-2, 0.1, -2], [2, 4, 2], (512, 3)).astype(np.float32)
    seeds = U32[1, :512]
    rd, ri, rs = ref.sample_lights(data, jnp.asarray(pos), jnp.asarray(seeds))
    pd, pi, ps = port.sample_lights(tdata, _t(pos), _t(seeds.astype(np.int64)))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(rs).astype(np.int64))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), atol=1e-6)
