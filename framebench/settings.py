"""A configuration's ``render`` block → a package's RenderSettings: the
port's or the reference copy's, which share the fields."""
from __future__ import annotations

import functools
import operator


def render_settings(render: dict, settings_cls, flags_cls, path_cls, **over):
    """``render``: width, height, path (a RenderPathType name), flags
    (RenderFlags names) and ``settings`` (further RenderSettings fields,
    as the configuration states them)."""
    flags = functools.reduce(operator.or_,
                             (flags_cls[f] for f in render["flags"]))
    fields = dict(render.get("settings", {}))
    fields.update(over)
    return settings_cls(width=int(render["width"]),
                        height=int(render["height"]),
                        path=path_cls[render["path"]], flags=flags, **fields)
