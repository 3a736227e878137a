"""Named ranges around the port's layers, for ``torch.profiler``.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler runs (``torch.profiler.profile`` sets
``torch.autograd.profiler._is_profiler_enabled``), so the range lands in the
same trace as the device's kernels, on the same clock, and every kernel and
every idle gap can be put down to the layer that launched it.  With no
profiler running it is one shared no-op context: it constructs nothing and
dispatches no op, which keeps a span free on the hot path.

The profiler is the store: ``prof.export_chrome_trace(path)`` writes the
ranges out.  There is no switch and no clock of this module's own.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` in an active profiler's trace, else the
    shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _profiler.record_function(name)
