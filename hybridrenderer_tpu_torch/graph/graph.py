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

    def reset(self):
        self.passes.clear()
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

    def execute(self, registry: dict, ctx, state: FrameState,
                run_pass=None):
        """Run every pass → (registry, new history dict). History reads
        fall back to the current-frame resource of the same name.
        ``run_pass(p, registry, ctx)``, when given, runs each pass in
        place of ``p.fn(registry, ctx)`` (runtime/profiling's tracer
        times each pass so)."""
        if not self._compiled:
            self.compile(external=tuple(registry.keys()))
        new_history: dict = {}
        for p in self.passes:
            for r in p.reads:
                if r.startswith("History_") and r not in registry:
                    hname = r[len("History_"):]
                    h = state.get(hname)
                    registry[r] = registry.get(hname) if h is None else h
            out = (p.fn(registry, ctx) if run_pass is None
                   else run_pass(p, registry, ctx)) or {}
            if set(out) != set(p.writes):
                raise ValueError(
                    f"pass '{p.name}' write mismatch: declared "
                    f"{sorted(p.writes)}, produced {sorted(out)}")
            registry.update(out)
            for virt, hname in p.save_as_history.items():
                new_history[hname] = registry[virt]
        return registry, new_history

    def export_mermaid(self) -> str:
        """The graph as Mermaid text (RenderGraph::ExportToMermaid)."""
        lines = ["graph TD"]
        style = {"graphics": ":::graphics", "compute": ":::compute",
                 "raytracing": ":::raytracing"}
        for i, p in enumerate(self.passes):
            lines.append(f"  P{i}[{p.name}]{style.get(p.kind, '')}")
            for r in p.reads:
                rid = r.replace(" ", "_")
                lines.append(f"  R_{rid}([{r}]) --> P{i}")
            for w in p.writes:
                wid = w.replace(" ", "_")
                lines.append(f"  P{i} --> R_{wid}([{w}])")
        lines += [
            "classDef graphics fill:#264653",
            "classDef compute fill:#2a9d8f",
            "classDef raytracing fill:#e76f51",
        ]
        return "\n".join(lines)
