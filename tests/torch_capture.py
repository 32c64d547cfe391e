"""A CPU check that a frame of the port can be captured into a CUDA graph.

A capture fails at the first operation that makes the host wait for the
card (reading a tensor's value, an output whose size depends on the
data) or that copies host data to the card (a tensor made from Python
numbers). On the CPU neither shows, so ``CaptureLint`` records the
operations that would do either, with the port's line that called them,
while a frame function runs on CPU tensors. Operations called from a
kernel's plain version are skipped: the card never runs those.
"""
from __future__ import annotations

import os
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_PORT = os.sep + "hybridrenderer_tpu_torch" + os.sep
aten = torch.ops.aten
# the output's size or value reaches the host
_SYNC = {aten._local_scalar_dense.default, aten.nonzero.default,
         aten.masked_select.default, aten.bincount.default,
         aten._unique2.default, aten.unique_dim.default,
         aten.unique_consecutive.default}
# a tensor made from host data
_HOST_DATA = {aten.lift_fresh.default, aten.lift_fresh_copy.default}


def _bool_index(indices) -> bool:
    return any(i is not None and i.dtype in (torch.bool, torch.uint8)
               for i in indices)


class CaptureLint(TorchDispatchMode):
    """Records ``(operation, port file:line)`` of every operation a CUDA
    graph capture would refuse, in ``found``."""

    def __init__(self):
        super().__init__()
        self.found = []

    def _refused(self, func, args, kwargs) -> bool:
        if func in _SYNC or func in _HOST_DATA:
            return True
        if func is aten.repeat_interleave.Tensor:
            return kwargs.get("output_size") is None
        if func in (aten.index.Tensor, aten.index_put.default,
                    aten.index_put_.default):
            return _bool_index(args[1])
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._refused(func, args, kwargs):
            stack = traceback.extract_stack()
            if not any(f.name.endswith("_plain") for f in stack):
                site = next((f"{os.path.basename(f.filename)}:{f.lineno}"
                             for f in reversed(stack)
                             if _PORT in f.filename), "?")
                self.found.append((str(func), site))
        return func(*args, **kwargs)
