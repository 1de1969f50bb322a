"""The port's named spans, on the profiler's clock.

``span(name, **args)`` marks a stretch of host code (a phase of
``generate``, a model layer, a phase of the train step) as a
``torch.profiler.record_function`` event, so that a profile holds the
program's own names beside the operators and kernels they launch::

    with span("repro_torch.serve.prefill", request=3):
        ...

    @traced("repro_torch.data.fetch")
    def move_down(self, core): ...

A span exists only while a profiler records. Otherwise ``span`` returns a
shared no-op context after one check of the profiler's state (about 0.1 µs,
where an unguarded ``record_function`` costs about 10 µs); there is no
switch. Nesting is the profiler's own timeline. Names read
``repro_torch.<part>.<what>``; ``args`` go into the event's argument string
(``request=3``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable

import torch
from torch.profiler import record_function

__all__ = ["span", "traced"]

_OFF = contextlib.nullcontext()


def span(name: str, **args: Any):
    """A ``record_function`` span named ``name`` while a profiler records,
    else a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return record_function(name, ", ".join(f"{k}={v}" for k, v in args.items()) or None)


def traced(name: str) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function runs inside ``span(name)``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*a: Any, **kw: Any) -> Any:
            with span(name):
                return fn(*a, **kw)

        return inner

    return wrap
