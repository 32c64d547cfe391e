"""Final post-process: exposure + gamma
(hybridrenderer_tpu/ops/postprocess.py)."""
from __future__ import annotations

import torch


def tonemap(color, exposure):
    c = color * exposure
    return torch.pow(torch.clamp(c, min=0.0), 1.0 / 2.2)
