"""The harness's code for mixer and MLP kinds that the built-in code lacks.

A configuration's ``pattern`` names each block's mixer and MLP kind. The
built-in code (``weights.Leaves``, ``reference.model.Ref``,
``count.work.Work``) knows ``attn`` and ``mamba``, ``dense``, ``moe`` and
``none``; for any other kind it calls the module ``archs/<kind>.py``, a
new file. It defines these functions, each taking the built-in object as
its first argument, for the configuration (``.cfg``), its widths
(``.z``, ``weights.dims``, on the weights and the work model) and the
reference's pieces (``mm``, ``norm``, ``rope``, ``attend``, ``moe``,
``mlp``):

* a mixer kind: ``leaves(lv, at)``, the weights' (path, shape, init) under
  ``at``; ``forward(ref, p, x, pos)``, ``state(ref, batch, max_len,
  device)`` and ``step(ref, p, x, t, state)``, the reference over a whole
  sequence and one position at a time; ``products(w, t)``, the layer's
  products of ``t`` tokens; ``forward_items(w, batch, seq)``,
  ``train_items(w, batch, seq, remat)`` and ``decode_items(w, batch, ctx)``,
  its attention-like work beside them;
* an MLP kind: ``leaves(lv, at)``, ``forward(ref, p, x)`` and
  ``products(w, t)``.

A kind with no module, or a module without the function asked for, raises.
This package imports nothing of the harness, so the built-ins can call it.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re
import sys
import types
from typing import Callable

__all__ = ["DIR", "find"]

#: where a kind ``<kind>`` finds ``<kind>.py``
DIR = pathlib.Path(__file__).resolve().parent

_loaded: dict[pathlib.Path, types.ModuleType] = {}


def _module(kind: str) -> types.ModuleType | None:
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,63}", kind):
        return None
    path = DIR / f"{kind}.py"
    if path not in _loaded:
        if not path.is_file():
            return None
        spec = importlib.util.spec_from_file_location(f"portbench.archs.{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _loaded[path] = mod
    return _loaded[path]


def find(kind: str, fn: str, what: str) -> Callable:
    """``fn`` of the module ``archs/<kind>.py``; ``what`` names the missing
    piece in the error (``"weights for mixer"``: "no weights for mixer
    'x'")."""
    mod = _module(str(kind))
    if mod is None or not callable(getattr(mod, fn, None)):
        raise ValueError(f"no {what} {kind!r}")
    return getattr(mod, fn)
