"""FrameState checkpoint / resume (hybridrenderer_tpu/runtime/state_io.py).

The reference's layout: one ``.npz`` with an ``h::<name>`` array per
history plane and ``__frame_count__``, so a state saved by either
package loads in the other. bfloat16 planes are written widened to
float32 (exactly): the reference writes them as raw 2-byte voids
(ml_dtypes' bfloat16), which its own ``load_state`` cannot read; this
one reads those back as bfloat16. ``restore_renderer`` writes into the
renderer's history buffers, which its captured frames read.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.params import FrameState


def _to_numpy(t) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _from_numpy(a) -> torch.Tensor:
    if a.dtype == np.dtype("V2"):    # the reference's bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def save_state(path: str, state: FrameState, frame_count: int):
    arrays = {f"h::{k}": _to_numpy(v) for k, v in state.history.items()}
    arrays["__frame_count__"] = np.asarray(frame_count)
    np.savez_compressed(path, **arrays)
    return path


def load_state(path: str, device="cpu"):
    """Returns (FrameState of tensors on ``device``, frame_count)."""
    with np.load(path) as z:
        history = {k[3:]: _from_numpy(z[k]).to(device)
                   for k in z.files if k.startswith("h::")}
        frame_count = int(z["__frame_count__"])
    return FrameState(history=history), frame_count


def save_renderer(path: str, renderer) -> str:
    return save_state(path, renderer.state, renderer.frame_count)


def restore_renderer(path: str, renderer):
    state, frame_count = load_state(path)
    renderer.set_history(state.history, frame_count)
    return renderer
