"""Utilities: device selection, kernel builds, weight import, plots, profiling."""

from . import plot, profiling  # noqa: F401
from .profiling import span, sync, trace  # noqa: F401

__all__ = [
    "plot",
    "profiling",
    "span",
    "sync",
    "trace",
]
