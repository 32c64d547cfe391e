"""Declarative render graph (hybridrenderer_tpu/graph/graph.py).

Named resources with read/write declarations and history saves. Passes
run eagerly in order; each pass's reads are validated when the graph is
compiled and its writes when it runs. The
reference's optimization barriers have no counterpart: eager PyTorch
materializes every pass output anyway.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from .params import FrameState


@dataclasses.dataclass
class PassDecl:
    name: str
    fn: Callable
    reads: List[str]
    writes: List[str]
    save_as_history: Dict[str, str]  # resource -> history name
    kind: str = "compute"            # graphics | compute | raytracing


class RenderGraph:
    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.passes: List[PassDecl] = []
        self._compiled = False

    def add_pass(self, name, fn, reads=(), writes=(), save_as_history=None,
                 kind="compute"):
        self.passes.append(PassDecl(name, fn, list(reads), list(writes),
                                    dict(save_as_history or {}), kind))
        return self

    def compile(self, external=()):
        available = set(external)
        history_names = {h for p in self.passes
                         for h in p.save_as_history.values()}
        for p in self.passes:
            for r in p.reads:
                if r.startswith("History_"):
                    hname = r[len("History_"):]
                    if hname not in history_names and hname not in available:
                        raise ValueError(
                            f"pass '{p.name}' reads '{r}' but no pass saves "
                            f"history '{hname}'")
                    continue
                if r not in available:
                    raise ValueError(
                        f"pass '{p.name}' reads undeclared resource '{r}' "
                        f"(available: {sorted(available)})")
            available.update(p.writes)
            for virt in p.save_as_history:
                if virt not in available:
                    raise ValueError(f"pass '{p.name}' saves '{virt}' as "
                                     "history but never produces it")
        self._compiled = True
        return self

    def execute(self, registry: dict, ctx, state: FrameState):
        """Run every pass → (registry, new history dict). History reads
        fall back to the current-frame resource of the same name."""
        if not self._compiled:
            self.compile(external=tuple(registry.keys()))
        new_history: dict = {}
        for p in self.passes:
            for r in p.reads:
                if r.startswith("History_") and r not in registry:
                    hname = r[len("History_"):]
                    h = state.get(hname)
                    registry[r] = registry.get(hname) if h is None else h
            out = p.fn(registry, ctx) or {}
            if set(out) != set(p.writes):
                raise ValueError(
                    f"pass '{p.name}' write mismatch: declared "
                    f"{sorted(p.writes)}, produced {sorted(out)}")
            registry.update(out)
            for virt, hname in p.save_as_history.items():
                new_history[hname] = registry[virt]
        return registry, new_history
