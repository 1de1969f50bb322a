"""The harness's spans around program functions while a stretch is traced.

Each ``wrap: <module>:<attribute>`` line of ``kernel_scopes/<class>.txt``
(or of ``<class>.<any>.txt``, ``tracing.class_lines``) names a program
function; inside ``wrapped()`` a call of it runs in a
``torch.profiler.record_function`` span ``portbench.<class>``, so that
``tracing`` assigns the kernels it launches to that class. A name the
program no longer has is passed over. Outside ``wrapped()`` the program is
as it was.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import pathlib
from typing import Any, Callable, Iterator

from portbench import tracing

__all__ = ["wraps", "wrapped"]


def wraps(root: pathlib.Path | None = None) -> list[tuple[str, str, str]]:
    """(class, module, attribute path) of every ``wrap:`` line under ``root``
    (default ``tracing.SCOPES``)."""
    out = []
    for cls, lines in tracing.class_lines(root or tracing.SCOPES).items():
        for ln in lines:
            key, _, value = ln.partition(":")
            if key == "wrap":
                module, _, attr = value.strip().partition(":")
                out.append((cls, module, attr))
    return out


def _in_span(fn: Callable, span: str) -> Callable:
    from torch.profiler import record_function

    @functools.wraps(fn)
    def inner(*args: Any, **kwargs: Any) -> Any:
        with record_function(span):
            return fn(*args, **kwargs)

    return inner


@contextlib.contextmanager
def wrapped(root: pathlib.Path | None = None) -> Iterator[list[str]]:
    """Run the program's wrapped functions in their spans; yields the names
    wrapped."""
    undo: list[tuple[Any, str, Any, bool]] = []
    done: list[str] = []
    try:
        for cls, module, attr in wraps(root):
            try:
                owner: Any = importlib.import_module(module)
            except ImportError:
                continue
            *parents, name = attr.split(".")
            for p in parents:
                owner = getattr(owner, p, None)
            fn = getattr(owner, name, None) if owner is not None else None
            if not callable(fn):
                continue
            own = name in vars(owner)
            setattr(owner, name, _in_span(fn, f"portbench.{cls}"))
            undo.append((owner, name, fn, own))
            done.append(f"{module}:{attr}")
        yield done
    finally:
        for owner, name, fn, own in reversed(undo):
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)
