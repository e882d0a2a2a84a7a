"""The active wall-span record: the one handle through which the model,
the LoRA wrapper and the kernel wrappers reach the ``WallSpans`` of the
serve that is running (``serving/trace.py``).

``EdgeLoRAEngine.serve`` sets ``wall`` for the length of a serve whose
tracer has its wall spans on, and sets it back to ``None`` in a
``finally``. Every site reads it once and guards on ``is not None``::

    sp = spans.wall
    if sp is not None:
        sp.open("qkv")
    ...
    if sp is not None:
        sp.close()

so with the record off a site costs one module attribute read and one
comparison: nothing is built, no clock is read and no profiler range is
entered. The module imports nothing, so every layer of the port can
import it without a cycle.
"""
from __future__ import annotations

from typing import Any

# the running serve's ``WallSpans``, or None
wall: Any = None
