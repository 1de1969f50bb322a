"""Declarative sharding specs: named partition rules that resolve per mesh.

The torchprime exemplar (SNIPPETS.md) configures sharding as data — name
patterns mapped to logical partition specs::

    model.layers.*.self_attn.q_proj.weight: [fsdp, null]

This module is that idea for our parameter/cache trees: a :class:`Rule`
table maps leaf-name patterns (fnmatch globs, ``w[qkv]`` style) to per-dim
*logical* axes, and a resolver turns a rule into a concrete partition
spec (:class:`P`, one entry per dim, as JAX's ``PartitionSpec`` holds
them) against a mesh — any object with an ordered ``shape`` (axis →
size) and ``axis_names``, such as :mod:`repro_torch.launch.mesh`'s. The
rules and their resolution are the JAX package's, so the port and the
reference shard the same leaves the same way. The table — not per-model code —
is the single source of truth: ``distributed.sharding`` builds its
``param_specs``/``cache_specs`` trees from it, the host-level cost model
reads the same resolved specs to derive the h-relation a sharded train
step pays (:func:`host_h_relation`), and ``launch/mesh.py``'s host meshes
are priced from it.

Logical axes (resolved by :func:`build_context`):

``tp``
    The tensor-parallel ``model`` mesh axis.
``ep``
    Expert parallelism — also the ``model`` axis, named separately so MoE
    rules read as what they are.
``dp``
    The combined data-parallel axes (``pod``/``host``/``data``), ungated —
    used for output dims that shard "for free" with the batch.
``fsdp``
    The same physical axes as ``dp``, but disabled under ``REPRO_NO_FSDP=1``
    (weights then replicate over DP instead of paying per-layer
    all-gathers — EXPERIMENTS.md §Perf A3).
``sp``
    Sequence parallelism over the ``data`` axis (long-context, batch 1).
``batch_dp``
    ``dp`` gated on the global batch actually dividing the DP world size —
    cache batch dims fall back to sequence sharding when it does not.

Resolution semantics (the part hand-written rules used to encode in
``if``/``elif`` chains): each :class:`Dim` lists *alternative* axis tuples
in preference order; an alternative is feasible when every physical axis
exists in the mesh, none was already assigned to another dim of the same
leaf, and the dim size divides the axes' product. Dims resolve in the
rule's ``priority`` order (so e.g. a KV cache's head dim gets first claim
on ``model`` before the sequence dim considers it), infeasible dims
degrade to replication — unless ``required``, in which case the whole rule
fails and the next matching rule in the table is tried (how MoE expresses
"expert-parallel if the expert count divides, else per-expert TP").
"""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from typing import Any, Iterable, Sequence

import numpy as np

__all__ = [
    "P",
    "AxisBinding",
    "dp_axes",
    "Dim",
    "Rule",
    "REPLICATED",
    "dim",
    "build_context",
    "resolve_leaf",
    "PARAM_RULES",
    "CACHE_RULES",
    "host_h_relation",
    "host_pricing_diagnostics",
    "spec_uses_axis",
    "tree_leaves",
    "leaf_shape",
]


# ------------------------------------------------------- the spec and DSL ----


class P(tuple):
    """A partition spec: one entry per array dim — ``None`` (replicated), a
    mesh axis name, or a tuple of them — as JAX's ``PartitionSpec`` holds
    them. A tuple, so specs compare and hash as their entries."""

    def __new__(cls, *entries: Any) -> "P":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of a tree of dicts, lists and tuples in walk order (dict
    keys sorted, as a JAX tree walks them); a :class:`P` is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def leaf_shape(leaf: Any) -> tuple[int, ...]:
    """A leaf's shape: a tensor's, or () for a Python scalar (the cache's
    ``len``)."""
    return tuple(getattr(leaf, "shape", ()))


@dataclasses.dataclass(frozen=True)
class Dim:
    """One array dim's sharding: alternative logical-axis tuples, in order.

    ``as_tuple`` forces the resolved entry into tuple form even for a single
    axis (PartitionSpec treats ``"model"`` and ``("model",)`` identically;
    the flag only preserves the historical spelling of multi-source dims
    like the KV sequence dim). ``required`` turns "no alternative fits" from
    replication into rule failure.
    """

    alts: tuple[tuple[str, ...], ...]
    required: bool = False
    as_tuple: bool = False


def dim(*alts: str | tuple[str, ...], required: bool = False,
        as_tuple: bool = False) -> Dim:
    norm = tuple((a,) if isinstance(a, str) else tuple(a) for a in alts)
    return Dim(norm, required=required, as_tuple=as_tuple)


REPLICATED = Dim(())


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named sharding rule: leaf pattern(s) + per-dim logical specs.

    ``pattern`` entries are fnmatch globs matched against the leaf name
    (no ``/``) or the whole ``a/b/c`` path (with ``/``). ``rank`` pins the
    rule to leaves of that *base* rank (shape rank minus the scan-stack
    dim), mirroring how one name can mean different things at different
    ranks (2-D ``wq`` is a sharded projection, 3-D ``wq`` a tiny
    block-diagonal per-head map). ``priority`` is the dim resolution order;
    dims beyond ``len(dims)`` replicate (``pad``), unless ``pad=False`` in
    which case the spec is exactly ``P(*entries)`` as given (``len``'s
    bare ``P()``).
    """

    pattern: str | tuple[str, ...]
    dims: tuple[Dim, ...]
    rank: int | None = None
    priority: tuple[int, ...] | None = None
    wrap_scanned: bool = True
    pad: bool = True

    def matches(self, names: Sequence[str], base_rank: int) -> bool:
        if self.rank is not None and base_rank != self.rank:
            return False
        pats = (self.pattern,) if isinstance(self.pattern, str) else self.pattern
        path = "/".join(names)
        for pat in pats:
            target = path if "/" in pat else names[-1]
            if fnmatch.fnmatchcase(target, pat):
                return True
        return False


@dataclasses.dataclass(frozen=True)
class AxisBinding:
    """A logical axis resolved to physical mesh axes (``None`` = disabled)."""

    axes: tuple[str, ...] | None
    string_form: bool = False   # single-axis entries render as a bare string


def _fsdp_enabled() -> bool:
    """REPRO_NO_FSDP=1 shards weights over the model axis only (TP), trading
    replicated-weight memory for the removal of per-layer DP all-gathers —
    the right point on the curve for ≤10B models (EXPERIMENTS.md §Perf A3)."""
    return os.environ.get("REPRO_NO_FSDP", "0") != "1"


def dp_axes(mesh: Any) -> tuple[str, ...]:
    """The combined data-parallel axes, outermost first. ``host`` counts:
    on a host×core mesh FSDP/ZeRO spans hosts too — that spanning is
    exactly the host-level h-relation the cost model charges."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "host", "data"))


def build_context(mesh: Any, *, batch_ok: bool = True) -> dict[str, AxisBinding]:
    dp = dp_axes(mesh)
    return {
        "tp": AxisBinding(("model",), string_form=True),
        "ep": AxisBinding(("model",), string_form=True),
        "dp": AxisBinding(dp),
        "fsdp": AxisBinding(dp if _fsdp_enabled() else None),
        "sp": AxisBinding(("data",), string_form=True),
        "batch_dp": AxisBinding(dp if batch_ok else None),
    }


# ---------------------------------------------------------- the resolver ----


def _axes_product(mesh: Any, axes: Iterable[str]) -> int | None:
    size = 1
    for a in axes:
        if a not in mesh.shape:
            return None
        size *= int(mesh.shape[a])
    return size


def _resolve_rule(rule: Rule, base: tuple[int, ...], ctx: dict[str, AxisBinding],
                  mesh: Any) -> P | None:
    """Resolve one rule against a leaf's base shape; None = rule failed."""
    if not rule.pad:
        return P(*[None] * len(rule.dims))
    entries: list[Any] = [None] * len(base)
    used: set[str] = set()
    order = rule.priority if rule.priority is not None else range(len(rule.dims))
    for i in order:
        d = rule.dims[i]
        if i >= len(base):
            raise ValueError(
                f"rule {rule.pattern!r} has {len(rule.dims)} dims for a "
                f"rank-{len(base)} leaf")
        chosen: list[str] | None = None
        chosen_alt: tuple[str, ...] | None = None
        chosen_binding: AxisBinding | None = None
        for alt in d.alts:
            phys: list[str] = []
            binding = None
            ok = True
            for logical in alt:
                if logical not in ctx:
                    raise ValueError(
                        f"rule {rule.pattern!r}: unknown logical axis "
                        f"{logical!r} (known: {sorted(ctx)})")
                binding = ctx[logical]
                if binding.axes is None:          # disabled (env gate / batch)
                    ok = False
                    break
                phys.extend(binding.axes)
            if not ok or not phys:
                continue
            if len(set(phys)) != len(phys) or any(a in used for a in phys):
                continue
            size = _axes_product(mesh, phys)
            if size is None or base[i] % size != 0:
                continue
            chosen, chosen_alt, chosen_binding = phys, alt, binding
            break
        if chosen is None:
            if d.required:
                return None
            continue
        used.update(chosen)
        # spelling follows the binding: single-logical single-axis dims keep
        # the bare-string form ("model"), combined dims the tuple form
        if (not d.as_tuple and len(chosen) == 1 and len(chosen_alt) == 1
                and chosen_binding is not None and chosen_binding.string_form):
            entries[i] = chosen[0]
        else:
            entries[i] = tuple(chosen)
    return P(*entries)


def resolve_leaf(rules: Sequence[Rule], names: Sequence[str],
                 shape: tuple[int, ...], ctx: dict[str, AxisBinding],
                 mesh: Any, *, scanned: bool, kind: str = "parameter") -> P:
    """Resolve a leaf against the rule table (first matching rule that
    succeeds wins; a failed ``required`` dim falls through to the next
    match — the declarative form of MoE's EP-else-TP choice)."""
    base = tuple(shape[1:]) if scanned else tuple(shape)
    for rule in rules:
        if not rule.matches(names, len(base)):
            continue
        spec = _resolve_rule(rule, base, ctx, mesh)
        if spec is None:
            continue
        if scanned and rule.wrap_scanned:
            return P(None, *spec)
        return spec
    raise ValueError(f"no {kind} rule for {'/'.join(map(str, names))}")


# --------------------------------------------------------------- the rules ----

# 2-D projections: fan-in sharded over FSDP, fan-out over TP — and the
# transpose pairing for the output side of a block.
_FAN_IN = (dim("fsdp"), dim("tp"))
_FAN_OUT = (dim("tp"), dim("dp"))

PARAM_RULES: tuple[Rule, ...] = (
    # ---- embeddings ----
    Rule("tokens", (dim("tp"), dim("dp")), rank=2),
    Rule("head", _FAN_IN, rank=2),
    # ---- norms / small vectors / per-head block-diagonals ----
    Rule(("scale", "bias", "if_bias", "dt_bias", "conv_b", "r", "router"), ()),
    # block-diagonal per-head (H, dh, dh): replicated — tiny, and sharding
    # dh forces GSPMD involuntary remat on the per-head einsum inside the
    # scanned/checkpointed body
    Rule("w[qkv]", (), rank=3),
    # ---- routed experts (E, ·, ·): EP over model when E divides, else
    # per-expert TP (qwen2-moe's 60 experts on a 16-wide model axis) ----
    Rule(("w_up", "w_gate"), (dim("ep", required=True), REPLICATED, dim("dp")),
         rank=3),
    Rule(("w_up", "w_gate"), (REPLICATED, REPLICATED, dim("tp")), rank=3),
    Rule("w_down", (dim("ep", required=True), dim("dp"), REPLICATED), rank=3),
    Rule("w_down", (REPLICATED, dim("tp"), REPLICATED), rank=3),
    # ---- fan-in → fan-out projections (TP on output) ----
    Rule(("wq", "wk", "wv", "w_up", "w_gate", "w_in", "w_z",
          "shared_up", "shared_gate"), _FAN_IN, rank=2),
    # ---- fan-out → fan-in projections (TP on input) ----
    Rule(("wo", "w_down", "w_out", "shared_down"), _FAN_OUT, rank=2),
    # ---- mamba ----
    Rule("conv_w", (REPLICATED, dim("tp")), rank=2),
    Rule("d_skip", (dim("tp"),), rank=1),
    Rule(("a_log", "w_x", "w_if"), (dim("tp"), REPLICATED), rank=2),
    Rule("w_dt", (REPLICATED, dim("tp")), rank=2),
)

CACHE_RULES: tuple[Rule, ...] = (
    Rule("len", (), pad=False, wrap_scanned=False),
    # (B, S, Hkv, hd): batch over DP when it divides; model prefers the
    # kv-head dim (priority resolves it before the sequence dim), else the
    # sequence dim; batch=1 long-context adds data to the sequence dim (SP)
    Rule(("k", "v"),
         (dim("batch_dp"),
          dim(("sp", "tp"), "tp", "sp", as_tuple=True),
          dim("tp"),
          REPLICATED),
         rank=4, priority=(0, 2, 1, 3)),
    Rule("conv", (dim("batch_dp"), REPLICATED, dim("tp")), rank=3),
    # mamba (B, di, ds) | slstm (B, H, dh): state feature dim over model
    Rule("h", (dim("batch_dp"), dim("tp"))),
    Rule("C", (dim("batch_dp"), REPLICATED, dim("tp"), REPLICATED), rank=4),
    Rule("n", (dim("batch_dp"), REPLICATED, dim("tp")), rank=3),
    Rule(("m", "c"), (dim("batch_dp"),)),
)


# ----------------------------------------------- host-level h-relation ----


def spec_uses_axis(spec: P, axis: str) -> bool:
    for entry in tuple(spec):
        if entry is None:
            continue
        entries = (entry,) if isinstance(entry, str) else tuple(entry)
        if axis in entries:
            return True
    return False


def host_h_relation(mesh: Any, spec_tree: Any, shape_tree: Any,
                    *, host_axis: str = "host") -> dict[str, float]:
    """The host-level superstep accounting a sharded train step implies.

    Reads the *same* resolved specs a sharded step executes and derives
    the words one host exchanges with the others per train step — the
    ``h_host`` the recursive cost ``T_device + g_host·h_host + l_host·s_host``
    charges (DESIGN.md §8):

    * a parameter sharded over the host axis (FSDP/ZeRO) is all-gathered in
      the forward and again in the backward pass, and its gradient
      reduce-scattered — three transfers of ``words·(hosts-1)/hosts`` each;
    * a parameter replicated across hosts pays one gradient all-reduce,
      ``2·words·(hosts-1)/hosts`` on a ring.

    ``supersteps`` counts the host barriers those three collective phases
    imply. This is a model, not a trace — the per-level
    predicted-vs-measured row in ``benchmarks/multihost.py`` is its
    validation.
    """
    hosts = int(mesh.shape.get(host_axis, 1))
    if hosts <= 1:
        return {"hosts": 1, "gathered_words": 0.0, "reduced_words": 0.0,
                "h_words": 0.0, "supersteps": 0.0}
    frac = (hosts - 1) / hosts
    gathered = 0.0
    reduced = 0.0
    for spec, leaf in zip(tree_leaves(spec_tree), tree_leaves(shape_tree)):
        words = float(np.prod(leaf_shape(leaf), dtype=np.float64))
        if spec_uses_axis(spec, host_axis):
            gathered += words
        else:
            reduced += words
    h_words = 3.0 * gathered * frac + 2.0 * reduced * frac
    return {
        "hosts": hosts,
        "gathered_words": gathered,
        "reduced_words": reduced,
        "h_words": h_words,
        "supersteps": 3.0,
    }


def host_pricing_diagnostics(plan: Any, mesh: Any, spec_tree: Any,
                             shape_tree: Any, *, host_axis: str = "host"):
    """Cross-check a plan's declared host pricing against resolved specs.

    Resolves :func:`host_h_relation` for ``(mesh, spec_tree, shape_tree)``
    and hands it to :func:`repro_torch.core.verify.verify_plan`, returning the
    pricing-consistency diagnostics (``BSPS161`` when the plan's declared
    ``host_comm_words``/``host_supersteps`` disagree with what the specs
    imply by more than the tolerance). Empty list means the declaration
    and the sharding table tell the same story.
    """
    from repro_torch.core.verify import verify_plan

    rel = host_h_relation(mesh, spec_tree, shape_tree, host_axis=host_axis)
    return [d for d in verify_plan(plan, host_h=rel) if d.code == "BSPS161"]
