"""Device mesh for the row-sharded frame
(hybridrenderer_tpu/parallel/mesh.py).

The reference's mesh is a 1-D ``Mesh('y')`` over one process's JAX
devices: image rows are sharded over it and the scene is replicated. The
port's mesh is the same in PyTorch idiom: one process driving a tuple of
``torch.device``s, one device per row shard. A device may repeat, so
that several shards share one card (or the CPU), the analog of the
reference's virtual CPU devices: the sharded frame's code paths run all
the same, and its output can be held against the single-device frame.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: tuple          # torch.device of each row shard, in row order

    def __len__(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: "int | None" = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` row shards: by default one for each
    visible CUDA card, or ``devices`` as given (which may repeat one).
    Raises where fewer cards exist than asked for, and never falls back
    to the CPU: a CPU mesh names its devices."""
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} "
                             f"devices given")
        count = torch.cuda.device_count()
        for d in devs:
            if d.type == "cuda" and (d.index or 0) >= count:
                raise ValueError(f"{d}: have {count} CUDA devices")
    else:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(for example ['cpu'] * 8) to shard on the "
                               "CPU")
        if n > count:
            raise ValueError(f"requested {n} devices, have {count}")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    if not devs:
        raise ValueError("make_mesh: a mesh needs a device")
    return Mesh(devs)


def row_sharding(mesh: Mesh, height: int) -> tuple:
    """Each shard's rows of an image ``height`` rows tall, as (first row,
    rows): equal blocks in mesh order."""
    n = len(mesh)
    if height % n:
        raise ValueError(f"height {height} not divisible by mesh size {n}")
    h = height // n
    return tuple((i * h, h) for i in range(n))


def to_device(obj, device):
    """``obj`` with every tensor it holds (in dataclasses, named or plain
    tuples, lists and dicts) on ``device``; a tensor already there is
    kept, not copied."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(x, device) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(x, device) for x in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def replicated(mesh: Mesh, obj) -> tuple:
    """``obj`` (a tensor, or a structure of them: a scene, a tracer) on
    each shard's device → one per shard; shards on one device share one
    copy."""
    copies = {d: to_device(obj, d) for d in mesh.distinct}
    return tuple(copies[d] for d in mesh.devices)
