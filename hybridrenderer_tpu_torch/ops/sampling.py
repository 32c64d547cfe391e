"""Monte-Carlo sampling with the reference's RNG
(hybridrenderer_tpu/ops/sampling.py).

The TEA seed hash and the xorshift-multiply float generator are uint32
arithmetic. PyTorch has no uint32 arithmetic with logical shifts, so
seeds are carried as int64 tensors holding values in [0, 2^32): every
product fits in 63 bits and is masked back to 32 bits, and right
shifts of non-negative int64 are logical. The results are bit-exact
against the JAX package.
"""
from __future__ import annotations

import torch

from ..core import maths
from ..core.types import INVALID_ID

PI = 3.14159265359
_MASK = 0xFFFFFFFF


def _u32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def init_random_seed(val0, val1):
    """TEA 16-round hash. Inputs: non-negative integer tensors (or ints)
    below 2^32; returns int64 holding uint32 values."""
    device = next((v.device for v in (val0, val1)
                   if isinstance(v, torch.Tensor)), None)
    v0, v1 = torch.broadcast_tensors(_u32(val0, device), _u32(val1, device))
    s0 = 0
    for _ in range(16):
        s0 = (s0 + 0x9E3779B9) & _MASK
        v0 = (v0 + ((((v1 << 4) + 0xA341316C) & _MASK)
                    ^ ((v1 + s0) & _MASK)
                    ^ (((v1 >> 5) + 0xC8013EA4) & _MASK))) & _MASK
        v1 = (v1 + ((((v0 << 4) + 0xAD90777D) & _MASK)
                    ^ ((v0 + s0) & _MASK)
                    ^ (((v0 >> 5) + 0x7E95761E) & _MASK))) & _MASK
    return v0


def random_float(seed):
    """(value in [0, 1) float32, new seed)."""
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & _MASK
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & _MASK
    seed = seed ^ (seed >> 15)
    return seed.to(torch.float32) / 4294967296.0, seed


def _cosine_dir(r1, r2, normal):
    """Cosine-weighted direction about ``normal`` from uniforms."""
    r = torch.sqrt(r1)
    phi = 2.0 * PI * r2
    use_y = (torch.abs(normal[..., 0]) > 0.1).unsqueeze(-1)
    ey = normal.new_tensor([0.0, 1.0, 0.0]).expand(normal.shape)
    ex = normal.new_tensor([1.0, 0.0, 0.0]).expand(normal.shape)
    helper = torch.where(use_y, ey, ex)
    tangent = maths.normalize(maths.cross(normal, helper))
    bitangent = maths.cross(normal, tangent)
    d = (tangent * (r * torch.cos(phi)).unsqueeze(-1)
         + bitangent * (r * torch.sin(phi)).unsqueeze(-1)
         + normal * torch.sqrt(torch.clamp(1.0 - r1, min=0.0)).unsqueeze(-1))
    return maths.normalize(d)


def cos_hemisphere_from_uniforms(r1, r2, normal):
    return _cosine_dir(r1, r2, normal)


def cos_hemisphere_sample(seed, normal):
    """(direction, new seed); two RandomFloat draws in reference order."""
    r1, seed = random_float(seed)
    r2, seed = random_float(seed)
    return _cosine_dir(r1, r2, normal), seed


def interleaved_cos_hemisphere(frame_index, normal, block: int = 8,
                               grid: int = 4, salt: int = 0x51AB7000):
    """One cosine direction per (block x block) pixel pattern per frame,
    aligned to each pixel's own normal frame (the TPU-coherent AO
    sampler of the reference, kept for its image)."""
    H, W = normal.shape[:2]
    P = grid * grid
    pat = torch.arange(P, dtype=torch.int64, device=normal.device)
    seed = init_random_seed(pat + salt, frame_index)
    r1, seed = random_float(seed)
    r2, seed = random_float(seed)

    def expand(v):
        tile = v.reshape(grid, grid).repeat_interleave(block, 0) \
            .repeat_interleave(block, 1)
        reps = (-(-H // (grid * block)), -(-W // (grid * block)))
        return tile.repeat(*reps)[:H, :W]

    return _cosine_dir(expand(r1), expand(r2), normal)


def blue_noise_uniforms(blue_noise, frame_index, H: int, W: int):
    """Per-pixel vec4 uniforms from the tiled blue-noise texture at
    ``pixel + frame * (123, 456)``."""
    Hn, Wn = blue_noise.shape[:2]
    fi = int(frame_index)
    dev = blue_noise.device
    ys = (torch.arange(H, device=dev)[:, None] + fi * 456) % Hn
    xs = (torch.arange(W, device=dev)[None, :] + fi * 123) % Wn
    return blue_noise[ys, xs]


def sample_triangle_uv(u):
    r = torch.sqrt(u[..., 0])
    return torch.stack([1.0 - r, u[..., 1] * r], dim=-1)


def sample_discrete_cdf(cdf, start, count, rand_val, max_count: int = 32):
    """Per-element binary search in a CDF segment."""
    last = torch.clamp(start + count - 1, min=0)
    x = rand_val * cdf[last]
    low = start
    high = start + count
    n = cdf.shape[0]
    for _ in range(max_count):
        needed = low < high
        mid = low + torch.div(high - low, 2, rounding_mode="floor")
        ge = x >= cdf[torch.clamp(mid, 0, n - 1)]
        low = torch.where(needed & ge, mid + 1, low)
        high = torch.where(needed & ~ge, mid, high)
    return torch.minimum(torch.clamp(low - start, min=0),
                         torch.clamp(count - 1, min=0))


def sample_lights(scene, position, seed):
    """Pick a light uniformly, an emissive triangle by area CDF, and a
    point on it → (direction, sampled instance, new seed)."""
    L = scene.lights.count
    shape = position.shape[:-1]
    if L == 0:
        return (torch.zeros_like(position),
                torch.full(shape, INVALID_ID, dtype=torch.int32,
                           device=position.device), seed)

    rand_l, seed = random_float(seed)
    rand_el, seed = random_float(seed)
    ru, seed = random_float(seed)
    rv, seed = random_float(seed)
    rand_uv = torch.stack([ru, rv], dim=-1)

    light_id = torch.clamp((rand_l * L).to(torch.int64), 0, L - 1)
    lights = scene.lights
    inst = lights.instance[light_id].to(torch.int64)
    env = lights.environment[light_id]
    elem = sample_discrete_cdf(lights.cdf,
                               lights.cdf_start[light_id].to(torch.int64),
                               lights.cdf_count[light_id].to(torch.int64),
                               rand_el)
    tri_uv = sample_triangle_uv(rand_uv)

    safe_inst = torch.clamp(inst, min=0)
    prim0 = torch.div(scene.instances.index_offset[safe_inst].to(torch.int64),
                      3, rounding_mode="floor")
    tri = prim0 + elem
    p0 = scene.triangles.v0[tri]
    p1 = scene.triangles.v1[tri]
    p2 = scene.triangles.v2[tri]
    light_pos = (p1 * tri_uv[..., 0:1] + p2 * tri_uv[..., 1:2]
                 + p0 * (1.0 - tri_uv[..., 0:1] - tri_uv[..., 1:2]))
    dir_area = maths.normalize(light_pos - position)

    z = 2.0 * rand_uv[..., 0] - 1.0
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * rand_uv[..., 1]
    dir_env = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)

    is_area = (inst != INVALID_ID).unsqueeze(-1)
    is_env = (env != INVALID_ID).unsqueeze(-1)
    direction = torch.where(is_area, dir_area,
                            torch.where(is_env, dir_env,
                                        torch.zeros_like(dir_env)))
    sampled = torch.where(inst != INVALID_ID, inst,
                          torch.full_like(inst, INVALID_ID)).to(torch.int32)
    return direction, sampled, seed


def offset_ray(p, n):
    """Self-intersection-safe ray origin offset with integer-ulp stepping
    (exact float/int bitcasts through ``Tensor.view``)."""
    origin = 1.0 / 32.0
    float_scale = 1.0 / 65536.0
    int_scale = 256.0

    of_i = (int_scale * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    stepped = p_bits + torch.where(p < 0, -of_i, of_i)
    p_int = stepped.view(torch.float32)
    return torch.where(torch.abs(p) < origin, p + float_scale * n, p_int)
