"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``, loaded by path as ``src/repro/lint.py`` loads them), on
the CPU at tiny sizes. Each example's functions take the same inputs in
both packages (weights carried from the JAX init through numpy); the
printed checks are read from the port's output. Tolerances: the cost
model, the ELL blocks and the submitted requests exactly; fp32 products
and losses within rtol 1e-5 (sums in another order), the prefill's logits
within atol 1e-4, the grad norm within rtol 1e-4.
"""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core import EPIPHANY_III as J_EPIPHANY_III
from repro.core import HyperstepCost as JHyperstepCost
from repro.core import inner_product_cost as j_inner_product_cost
from repro.core.bsp import BSPAccelerator as JPack
from repro.core.plan import autotune as j_autotune
from repro.distributed.cannon import cannon_plan as j_cannon_plan
from repro.distributed.cannon import two_level_cannon as j_two_level_cannon
from repro.launch.serve import make_prefill as j_make_prefill
from repro.models import model as JM
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.schedule import constant as jconstant
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import EPIPHANY_III, BSPAccelerator
from repro_torch.examples import bsps_cannon, bsps_spmv, quickstart, serve_engine, serve_lm
from repro_torch.examples import train_lm
from repro_torch.models import model as TM
from repro_torch.models.model import count_params

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")
EXAMPLES = [quickstart, serve_lm, serve_engine, train_lm, bsps_cannon, bsps_spmv]


def _reference(stem: str):
    """The JAX package's ``examples/<stem>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(f"_ref_{stem}", ROOT / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _pair(name: str, **over):
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32", **over)
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32", **over)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, TM.params_from_numpy(tc, _np_tree(jp), device="cpu")


# ------------------------------------------------------------ quickstart ----


def test_quickstart_cost_rows_are_the_reference_s():
    (row,) = quickstart.cost_rows([EPIPHANY_III])
    t = j_inner_product_cost(J_EPIPHANY_III, N=1 << 20, C=4096)
    h = JHyperstepCost(bsp_flops=2 * 4096, fetch_words=[2 * 4096])
    assert row == {"name": J_EPIPHANY_III.name, "e": J_EPIPHANY_III.e,
                   "seconds": J_EPIPHANY_III.flops_to_seconds(t),
                   "bandwidth_heavy": bool(h.bandwidth_heavy(J_EPIPHANY_III))}


def _dot_line(text: str) -> tuple[float, float, int]:
    m = re.search(r"v·u = (\S+) \(numpy: (\S+)\) in (\d+) hypersteps", text)
    return float(m.group(1)), float(m.group(2)), int(m.group(3))


def test_quickstart_inner_product_prints_the_reference_s_check(capsys):
    _reference("quickstart").demo_bsps_program()
    want = _dot_line(capsys.readouterr().out)
    quickstart.demo_bsps_program(CPU)
    got = _dot_line(capsys.readouterr().out)
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0], rel=1e-5, abs=0.01)


def test_quickstart_lm_step_matches_the_reference():
    jc, tc, jp, tp = _pair("qwen2-moe-a2.7b")
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    opt = JAdamW(schedule=jconstant(1e-3))
    _, _, want = jax.jit(j_make_train_step(jc, opt))(
        jp, opt.init(jp), {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    got = quickstart.lm_step(tc, tp, torch.as_tensor(toks), CPU)
    for k in ("loss", "moe_aux"):
        assert got[k] == pytest.approx(float(want[k]), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(float(want["grad_norm"]), rel=1e-4)


def test_quickstart_runs_its_three_demos_on_the_cpu(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert all(f"== {i}." in out for i in (1, 2, 3))
    got, want, n = _dot_line(out)
    assert got == pytest.approx(want, rel=1e-5, abs=0.01) and n == 16
    assert re.search(r"qwen2-moe-a2.7b: loss \d+\.\d+ moe_aux", out)


# -------------------------------------------------------------- serving ----


def test_serve_lm_prefill_matches_the_reference():
    jc, tc, jp, tp = _pair("minicpm-2b")
    prompt = np.random.default_rng(2).integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    jcache = JM.init_cache(jc, 2, 9)
    jlogits, _ = j_make_prefill(jc)(jp, jcache, jnp.asarray(prompt))
    out = serve_lm.serve(tc, tp, torch.as_tensor(prompt), 3, 0.8, CPU)
    np.testing.assert_allclose(out["prefill_logits"].numpy(), np.asarray(jlogits)[:, -1],
                               rtol=0, atol=1e-4)
    assert tuple(out["tokens"].shape) == (2, 3) and out["cache_len"] == 9


def test_serve_lm_prints_its_row_on_the_cpu(capsys):
    out = serve_lm.main(["--arch", "minicpm-2b", "--batch", "2", "--prompt-len", "4",
                         "--gen", "3", "--device", "cpu"])
    line = capsys.readouterr().out
    assert re.search(r"\[serve\] minicpm-2b \(smoke\) batch=2: prefill \d+ms for 4 tokens \| "
                     r"decode p50 .* tok/s \| cache len 7", line)
    assert out["cache_len"] == 7


def test_serve_engine_submits_and_drains_as_the_reference_does(capsys, monkeypatch):
    """The same requests (the submit lines, exactly) and the same totals:
    every request drained with its budget of tokens."""
    args = ["--lanes", "2", "--segment", "4", "--pool-seq", "48", "--requests", "3"]
    monkeypatch.setattr(sys, "argv", ["serve_engine.py", *args])
    _reference("serve_engine").main()
    want = capsys.readouterr().out
    out = serve_engine.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out

    def submits(text):
        return [ln for ln in text.splitlines() if ln.startswith("submit")]

    def totals(text):
        return re.search(r"(\d+) requests, (\d+) tokens", text).groups()

    assert submits(got) == submits(want) and len(submits(got)) == 3
    assert totals(got) == totals(want)
    cfg = t_config("minicpm-2b", smoke=True)
    # each request's tokens: its prompt, then its budget
    assert [len(out[i]) for i in range(3)] == [len(p) + s for p, s in serve_engine.requests(
        3, 4, cfg.vocab_size)]


# ------------------------------------------------------------- training ----


@pytest.mark.parametrize("size", list(train_lm.SIZES))
def test_train_lm_config_is_the_reference_s(size):
    ref = _reference("train_lm")
    assert train_lm.SIZES == ref.SIZES
    assert (dataclasses.asdict(train_lm.make_config(size))
            == dataclasses.asdict(ref.make_config(size)))
    assert count_params(train_lm.make_config(size)) == int(JM.count_params(ref.make_config(size)))


def test_train_lm_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """Two steps, then the same directory asked for four: the second run
    resumes at step 2 and trains the last two."""
    args = ["--seq-len", "16", "--batch", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    out = train_lm.main(["--steps", "2", *args])
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "[done] steps=2" in capsys.readouterr().out
    again = train_lm.main(["--steps", "4", *args])
    text = capsys.readouterr().out
    assert "[resume] step 2" in text and "[done] steps=2" in text
    assert len(again["history"]) == 2


# --------------------------------------------------------- the algorithms ----


def test_bsps_cannon_picks_the_reference_s_m_and_multiplies():
    n = 64
    pack = BSPAccelerator(**PACK)
    best, choices = bsps_cannon.choose_m(n, 1, pack)
    cands = [{"m_blocks": m} for m in (1, 2, 4, 8, 16) if n // m >= 8]
    jbest, jchoices = j_autotune(lambda m_blocks: j_cannon_plan(n, m_blocks, 1), cands,
                                 JPack(**PACK))
    assert best.params == jbest.params
    assert [c.predicted_seconds for c in choices] == [c.predicted_seconds for c in jchoices]
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    b = rng.standard_normal((n, n)).astype(np.float32)
    c, row = bsps_cannon.run_compiled(a, b, 2, 1, None, pack, CPU)
    jc, _ = j_two_level_cannon(a, b, 2, machine=JPack(**PACK))
    np.testing.assert_allclose(c, np.asarray(jc), rtol=1e-5, atol=1e-5)
    assert np.abs(c - a.astype(np.float64) @ b).max() < 1e-4
    assert row["fetch_words_planned"] == row["fetch_words_measured"]


def test_bsps_cannon_prints_its_runs_on_the_cpu(capsys):
    errs = bsps_cannon.main(["64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[autotune] picked M=" in out and "[modes] M=4" in out
    assert set(errs) >= {2, 4} and max(errs.values()) < 1e-4


def test_bsps_spmv_blocks_and_product_are_the_reference_s():
    ref = _reference("bsps_spmv")
    cols, vals, x = bsps_spmv.make_ell_blocks(256, 0.05, 32)
    for got, want in zip((cols, vals, x), ref.make_ell_blocks(256, 0.05, 32)):
        np.testing.assert_array_equal(got, want)
    runner, sy, state0 = bsps_spmv.make_spmv_runner(cols, vals, x, BSPAccelerator(**PACK),
                                                     device="cpu")
    runner.run(state0(), compiled=True)
    jrunner, jsy, jstate0 = ref.make_spmv_runner(cols, vals, x, JPack(**PACK))
    jrunner.run(jstate0(), compiled=True)
    y = np.asarray(sy.data).reshape(-1)
    np.testing.assert_allclose(y, np.asarray(jsy.data).reshape(-1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, bsps_spmv.reference_spmv(cols, vals, x), rtol=1e-5, atol=1e-5)
    assert runner.predicted_vs_measured()["fetch_words_planned"] == \
        jrunner.predicted_vs_measured()["fetch_words_planned"]


def test_bsps_spmv_runs_as_a_module_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "repro_torch.examples.bsps_spmv", "1024",
                          "--device", "cpu"], capture_output=True, text=True, timeout=120,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    err = float(re.search(r"err=(\S+) ", out.stdout).group(1))
    assert err < 1e-4 and "measured per-hyperstep" in out.stdout


@pytest.mark.parametrize("example", EXAMPLES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_refuse_to_guess_the_device(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
