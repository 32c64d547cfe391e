"""The HYBRID path's reference: render.py's."""
from .render import Reference

__all__ = ["Reference"]
