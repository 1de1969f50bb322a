"""Runs of each cell on the CPU at smoke widths, skipping only the harness's
look for a card: sound, they come out ``correct`` under the cell's own
limits; with the timed path broken underneath (a fault planted in the
program), and with the fp8 control in the program's place, they do not."""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from portbench import run

BENCH = run.manifest()
CELLS = {w["name"]: w for w in BENCH["workloads"]}


def limits(cell: str) -> dict:
    return json.loads((run.HERE / "limits" / f"{cell}.json").read_text())


def run_smoke(smoke, cell: str, seed: int = 20240612, bench: dict = BENCH) -> dict:
    # the seed picks the first window call for the check (seed % 2 and % 4)
    wl = run.find(bench["workloads"], cell, "workload")
    return run.run_cell(cell, seed, 0.2, False, device="cpu", bench=bench,
                        cfg=smoke[0](wl["config"]), traffic=smoke[1](wl["traffic"]),
                        limits=limits(cell))


def control(smoke, cell: str, seed: int = 7, bench: dict = BENCH) -> dict:
    """The control's numbers of ``cell`` at its smoke widths, widened by
    ``smoke/controls/<cell>.json`` where that file exists: where the smoke
    widths are too narrow for fp8's error to reach the cell's limit (ttft
    compares one token a request, and two layers of width 64 over 256 tokens
    seldom reorder it; decode's spans of a row hold two tokens at smoke
    widths, where the cell's hold 64)."""
    wl = run.find(bench["workloads"], cell, "workload")
    cfg, tr = smoke[0](wl["config"]), smoke[1](wl["traffic"])
    widths = run.HERE / "smoke" / "controls" / f"{cell}.json"
    if widths.exists():
        cfg.update(json.loads(widths.read_text()))
    kind = importlib.import_module(f"portbench.kinds.{tr['kind']}")
    ctx = run.Context(cell, cfg, tr, seed, 0.0, torch.device("cpu"))
    return dict(kind.control_numbers(ctx))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(smoke, cell):
    res = run_smoke(smoke, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(smoke, cell):
    lim = limits(cell)
    numbers = control(smoke, cell)
    assert any(v > lim[k] for k, v in numbers.items()), (numbers, lim)


def _unchanged_update(self, grads, state, params, **kw):
    step = state["step"] + 1
    return params, dict(state, step=step), {"grad_norm": torch.zeros(()), "lr": torch.zeros(())}


def _half_batch(make):
    def made(*a, **kw):
        step = make(*a, **kw)

        def half(params, state, batch):
            n = batch["labels"].shape[0] // 2
            return step(params, state, {k: v[:n] for k, v in batch.items()})

        return half

    return made


def test_train_step_returning_its_state_unchanged_is_caught(smoke, monkeypatch):
    from repro_torch.optim import adamw

    monkeypatch.setattr(adamw.AdamW, "update", _unchanged_update)
    assert not run_smoke(smoke, "minicpm-2b.train-s2048")["correct"]


def test_train_step_on_half_the_batch_is_caught(smoke, monkeypatch):
    from repro_torch.train import steps

    monkeypatch.setattr(steps, "make_train_step", _half_batch(steps.make_train_step))
    assert not run_smoke(smoke, "minicpm-2b.train-s2048")["correct"]


#: where a fault alters the served tokens or the scores: every row and
#: position, one row (a slot of the decode batch, a document), or the last
#: tenth of the positions of every row
WHERE = {"all": (slice(None), slice(None)), "one_row": (0, slice(None)),
         "late_positions": (slice(None), "late")}


def _at(where: str, n: int):
    rows, cols = WHERE[where]
    return rows, (slice(n - max(1, n // 10), n) if cols == "late" else cols)


def _altered_generate(generate, where: str):
    """Served tokens altered where they are produced."""

    def altered(cfg, params, prompt, *, steps, **kw):
        out, stats = generate(cfg, params, prompt, steps=steps, **kw)
        out = out.clone()
        n = prompt.shape[1]
        served = out[:, n:]
        at = _at(where, served.shape[1])
        served[at] = (served[at] + cfg.vocab_size // 2) % cfg.vocab_size
        return out, stats

    return altered


@pytest.mark.parametrize("cell,where", [("jamba-v0.1-52b.decode-b64", "all"),
                                        ("jamba-v0.1-52b.decode-b64", "one_row"),
                                        ("jamba-v0.1-52b.decode-b64", "late_positions"),
                                        ("minicpm-2b.ttft-1k-4k", "all")])
def test_a_served_token_altered_is_caught(smoke, monkeypatch, cell, where):
    from repro_torch.launch import serve

    monkeypatch.setattr(serve, "generate", _altered_generate(serve.generate, where))
    assert not run_smoke(smoke, cell)["correct"]


@pytest.mark.parametrize("where", ["one_row", "late_positions"])
def test_a_score_altered_is_caught(smoke, monkeypatch, where):
    from repro_torch.train import steps

    make = steps.make_prefill_step

    def made(*a, **kw):
        step = make(*a, **kw)

        def altered(params, batch):
            # the scores altered where they are produced: the logits of the
            # positions that score the next token, but the last
            logits = step(params, batch).clone()
            scored = logits[:, :-1]
            at = _at(where, scored.shape[1])
            scored[at] = scored[at].flip(-1)
            return logits

        return altered

    monkeypatch.setattr(steps, "make_prefill_step", made)
    assert not run_smoke(smoke, "jamba-v0.1-52b.score-s4096")["correct"]
