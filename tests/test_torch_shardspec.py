"""The port's sharding tables against the JAX package's, on shape-only meshes.

``distributed/shardspec`` and ``distributed/sharding``'s spec functions are
pure Python over rule tables, so the port must resolve every leaf of every
config exactly as the reference does: the parameter specs on the production
meshes and a (host 2, data 2, model 2) mesh, the cache and batch specs for
every config × shape with ``REPRO_NO_FSDP`` set and unset, the host-level
h-relation and its pricing diagnostics, and the rule errors' messages.

The port keeps its stack per layer, so its parameter tree is the reference's
``scan_layers=False`` tree; the reference's period-stacked specs (its default
for the full configs) are compared too, with their leading ``None`` for the
period axis. Specs compare with one spelling for ``('data',)`` and ``'data'``
(JAX 0.9 spells them alike). The port is not held to
``tests/golden_shardings.json``: some of the reference's own cases there are
red (ROADMAP Queue 3's caveat).
"""

import dataclasses
import functools

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, SHAPES
from repro.configs import get_config as jget
from repro.core import plan as jplan
from repro.distributed import sharding as jsh
from repro.distributed import shardspec as jssp
from repro.models import model as JM
from repro_torch.configs import get_config as tget
from repro_torch.core import plan as tplan
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed import shardspec as tssp
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as TM


class _FakeMesh:
    """Shape-only stand-in for a JAX mesh (the reference's tests use one)."""

    def __init__(self, shape: dict[str, int]):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "prod": {"data": 16, "model": 16},
    "prod_mp": {"pod": 2, "data": 16, "model": 16},
    "host": {"host": 2, "data": 2, "model": 2},
}


def _meshes(name):
    return _FakeMesh(dict(MESHES[name])), tmesh.Mesh(dict(MESHES[name]))


def _entry(e):
    """One spelling per entry: a 1-tuple is its axis name."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _norm(spec):
    return tuple(_entry(e) for e in tuple(spec))


def _dump_jax(tree) -> dict:
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP)):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = _norm(spec)
    return out


def _dump_torch(tree) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + [str(k)])
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + [str(i)])
        else:
            out["/".join(path)] = _norm(t)

    walk(tree, [])
    return out


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return TM.abstract_params(tget(arch))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, scan: bool):
    return JM.abstract_params(dataclasses.replace(jget(arch), scan_layers=scan))


@pytest.fixture(params=["0", "1"], ids=["fsdp", "no_fsdp"])
def fsdp_env(request, monkeypatch):
    monkeypatch.setenv("REPRO_NO_FSDP", request.param)
    return request.param


@pytest.mark.parametrize("mname", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mname, fsdp_env):
    jmesh, mesh = _meshes(mname)
    got = _dump_torch(tsh.param_specs(tget(arch), mesh, _port_params(arch)))
    # the per-layer tree: the same paths, the same specs
    want = _dump_jax(jsh.param_specs(dataclasses.replace(jget(arch), scan_layers=False),
                                     jmesh, _ref_params(arch, False)))
    assert got == want
    # the reference's period-stacked tree: each layer's spec behind the
    # period axis's None
    stacked = _dump_jax(jsh.param_specs(jget(arch), jmesh, _ref_params(arch, True)))
    for key, spec in got.items():
        parts = key.split("/")
        if parts[0] == "stack":
            assert stacked["/".join(["stack"] + parts[2:])] == (None, *spec), key
        else:
            assert stacked[key] == spec, key


@pytest.mark.parametrize("sname", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_reference(arch, sname):
    shape = SHAPES[sname]
    length = min(shape.seq_len, 4096)
    jcfg = dataclasses.replace(jget(arch), scan_layers=False)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, shape.global_batch, length))
    tcache = TM.abstract_cache(tget(arch), shape.global_batch, length)
    with pytest.MonkeyPatch.context() as mp:
        for env in ("0", "1"):
            mp.setenv("REPRO_NO_FSDP", env)
            for mname in MESHES:
                jmesh, mesh = _meshes(mname)
                got = _dump_torch(tsh.cache_specs(tget(arch), mesh, shape, tcache))
                want = _dump_jax(jsh.cache_specs(jcfg, jmesh, shape, jcache))
                assert got == want, (mname, env)
                assert _norm(tsh.batch_spec(tget(arch), mesh, shape)) == _norm(
                    jsh.batch_spec(jcfg, jmesh, shape)), (mname, env)


@pytest.mark.parametrize("arch", ["minicpm-2b", "jamba-v0.1-52b", "qwen2-moe-a2.7b"])
def test_host_h_relation_and_pricing_equal_reference(arch):
    jmesh, mesh = _meshes("host")
    jcfg = dataclasses.replace(jget(arch), scan_layers=False)
    jshapes = _ref_params(arch, False)
    jspecs = jsh.param_specs(jcfg, jmesh, jshapes)
    tshapes = _port_params(arch)
    tspecs = tsh.param_specs(tget(arch), mesh, tshapes)
    want = jssp.host_h_relation(jmesh, jspecs, jshapes)
    got = tssp.host_h_relation(mesh, tspecs, tshapes)
    assert got == want and want["hosts"] == 2 and want["h_words"] > 0
    # a single-host mesh pays nothing
    one = tmesh.Mesh({"data": 2, "model": 2})
    assert tssp.host_h_relation(one, tspecs, tshapes) == jssp.host_h_relation(
        _FakeMesh({"data": 2, "model": 2}), jspecs, jshapes)

    def plan(k, words):
        return k.StreamPlan(
            name="host-priced", grid=(4,),
            inputs=(k.TokenSpec(name="a", block_shape=(4,), index_map=lambda h: (h,),
                                full_shape=(16,)),),
            outputs=(), flops_per_hyperstep=1.0,
            host_comm_words_per_hyperstep=words, host_supersteps_per_hyperstep=3.0)

    for words in (want["h_words"], want["h_words"] / 3):     # agrees; disagrees (BSPS161)
        jd = jssp.host_pricing_diagnostics(plan(jplan, words), jmesh, jspecs, jshapes)
        td = tssp.host_pricing_diagnostics(plan(tplan, words), mesh, tspecs, tshapes)
        assert [d.format() for d in td] == [d.format() for d in jd]
    assert [d.code for d in td] == ["BSPS161"]


def _errors(mod, mesh, rules, names, shape):
    ctx = mod.build_context(mesh)
    with pytest.raises(ValueError) as e:
        mod.resolve_leaf(rules, names, shape, ctx, mesh, scanned=False)
    return str(e.value)


@pytest.mark.parametrize("case", ["unknown_axis", "rank", "no_rule"])
def test_rule_errors_carry_the_reference_messages(case):
    jmesh, mesh = _meshes("prod")
    rules = {
        "unknown_axis": lambda m: (m.Rule("w", (m.dim("bogus"),), rank=1),),
        "rank": lambda m: (m.Rule("w", (m.dim("tp"), m.dim("fsdp")), rank=None),),
        "no_rule": lambda m: (m.Rule("v", (m.dim("tp"),), rank=1),),
    }[case]
    assert _errors(tssp, mesh, rules(tssp), ["w"], (64,)) == _errors(
        jssp, jmesh, rules(jssp), ["w"], (64,))


def test_resolution_semantics_on_the_stand_in():
    # EP else TP: a required dim that does not divide falls to the next rule;
    # a dim that does not divide replicates
    mesh = tmesh.make_production_mesh()
    rules = (
        tssp.Rule("w", (tssp.dim("ep", required=True), tssp.REPLICATED), rank=2),
        tssp.Rule("w", (tssp.REPLICATED, tssp.dim("tp")), rank=2),
    )
    ctx = tssp.build_context(mesh)
    assert tssp.resolve_leaf(rules, ["w"], (60, 64), ctx, mesh, scanned=False) == (None, "model")
    assert tssp.resolve_leaf(rules, ["w"], (64, 64), ctx, mesh, scanned=False) == ("model", None)
    assert tssp.resolve_leaf(rules, ["w"], (4, 60, 64), ctx, mesh, scanned=True) == (
        None, None, "model")
    assert tssp.spec_uses_axis(tssp.P(("pod", "data"), None), "data")
    assert not tssp.spec_uses_axis(tssp.P(None, "model"), "data")
    assert mesh.size == 256 and mesh.axis_names == ("data", "model")
    assert tmesh.make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert tssp.dp_axes(tmesh.make_production_mesh(multi_pod=True)) == ("pod", "data")


def test_host_meshes_over_the_devices_that_exist():
    mesh = tmesh.make_host_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.devices.shape == (1, 1)
    assert tmesh.make_host_core_mesh(1, device="cpu").shape == {"host": 1, "data": 1,
                                                                 "model": 1}
    with pytest.raises(ValueError, match=r"model=2 exceeds the 1 available device\(s\)"):
        tmesh.make_host_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="hosts must be positive, got 0"):
        tmesh.make_host_core_mesh(0, device="cpu")
    with pytest.raises(ValueError, match=r"hosts=2 exceeds the 1 available device\(s\)"):
        tmesh.make_host_core_mesh(2, device="cpu")
