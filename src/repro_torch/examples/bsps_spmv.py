"""BSPS sparse matrix-vector multiplication — the paper's §7 future work.

"We have some preliminary work on sparse matrix vector multiplication …
within the BSPS model." This example realises it: the sparse matrix (CSR,
padded to fixed-nnz row blocks — ELL-style tokens so every token has the
paper's constant size C_i) streams from external memory; the dense vector x
is the *resident* data structure in local memory; each hyperstep multiplies
one row-block token into a y-block that streams back *up*. Arithmetic
intensity is ~2 FLOPs per streamed word, so the BSPS cost model predicts
bandwidth-heavy hypersteps on every machine with e > 1.

The run executes through ``HyperstepRunner(plan=host_plan(...), machine=...)``
in both execution modes: the **compiled** replay (prints hypersteps/sec) and
the instrumented **measure** host loop, whose per-hyperstep compute/fetch
records validate the bandwidth-vs-compute classification. Each hyperstep's
product is a gather and a row sum (torch ops: no kernel of the port).

Run: python -m repro_torch.examples.bsps_spmv [n] [density] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import HyperstepRunner, StreamSet, host_plan
from repro_torch.core.calibrate import calibrate
from repro_torch.device import resolve_device

__all__ = ["make_ell_blocks", "make_spmv_runner", "reference_spmv", "main"]


def make_ell_blocks(n: int, density: float, block_rows: int, seed: int = 0):
    """Random sparse matrix as ELL row-block tokens (cols, vals) + dense x."""
    rng = np.random.default_rng(seed)
    nnz_per_row = max(1, int(n * density))
    cols = rng.integers(0, n, (n, nnz_per_row), dtype=np.int32)
    vals = rng.standard_normal((n, nnz_per_row)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    nb = n // block_rows
    return (cols.reshape(nb, block_rows, nnz_per_row),
            vals.reshape(nb, block_rows, nnz_per_row), x)


def make_spmv_runner(cols, vals, x, acc=None, *, device=None):
    """(runner, y_stream, state0): one y row-block streams up per hyperstep,
    on ``device`` (the card unless the caller names the CPU)."""
    device = resolve_device(device)
    nb, block_rows, nnz = cols.shape
    ss = StreamSet()
    sc = ss.create(cols, 1, name="cols")
    sv = ss.create(vals, 1, name="vals")
    sy = ss.create(np.zeros((nb, block_rows), np.float32), 1, name="y")
    xd = torch.as_tensor(x, device=device)        # resident vector (local mem)

    def step(state, toks):
        c, v = toks[0][0], toks[1][0]
        return state, [torch.einsum("rj,rj->r", v, xd[c.long()])]

    plan = host_plan(
        [sc, sv], out_streams=[sy],
        # one multiply-add per stored nonzero of the row block
        flops_per_hyperstep=2.0 * block_rows * nnz,
        name=f"spmv_n{cols.shape[0] * block_rows}",
    )
    runner = HyperstepRunner(step, [sc, sv], out_streams=[sy], device=device, plan=plan,
                             machine=acc)
    return runner, sy, (lambda: torch.zeros((), dtype=torch.int32, device=device))


def reference_spmv(cols, vals, x) -> np.ndarray:
    """y = A·x from the ELL blocks, one stored column at a time in numpy."""
    n = cols.shape[0] * cols.shape[1]
    nnz = cols.shape[2]
    ref = np.zeros(n, np.float32)
    flat_c, flat_v = cols.reshape(n, nnz), vals.reshape(n, nnz)
    for j in range(nnz):
        ref += flat_v[:, j] * x[flat_c[:, j]]
    return ref


def main(argv: list[str] | None = None) -> float:
    """Run the example; returns the compiled run's max error against
    :func:`reference_spmv`."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.bsps_spmv")
    ap.add_argument("n", type=int, nargs="?", default=1 << 14)
    ap.add_argument("density", type=float, nargs="?", default=0.01)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, density = args.n, args.density
    block_rows = 512
    cols, vals, x = make_ell_blocks(n, density, block_rows)
    nb, _, nnz = cols.shape
    acc = calibrate(device=device)

    # -- compiled mode: the whole pass is one replay --------------------------
    runner, sy, state0 = make_spmv_runner(cols, vals, x, acc, device=device)
    runner.run(state0(), compiled=True)          # warm up
    runner.reset_records()
    t0 = time.perf_counter()
    runner.run(state0(), compiled=True)
    compiled_s = time.perf_counter() - t0
    y = np.asarray(sy.data).reshape(n)
    err = float(np.abs(y - reference_spmv(cols, vals, x)).max())

    row = runner.predicted_vs_measured()
    regime = "bandwidth" if row["bandwidth_heavy_predicted"] else "compute"
    print(f"spmv n={n} nnz/row={nnz} blocks={nb}: err={err:.2e} "
          f"compiled={compiled_s * 1e3:.1f}ms "
          f"({nb / compiled_s:.0f} hypersteps/s, 1 replay) "
          f"predicted={row['predicted_seconds'] * 1e3:.1f}ms | "
          f"model says {regime}-heavy (e={acc.e:.1f}) | "
          f"fetch words planned={row['fetch_words_planned']:.0f} "
          f"measured={row['fetch_words_measured']:.0f}")

    # -- measure mode: per-hyperstep records validate the classification -----
    m_runner, m_sy, m_state0 = make_spmv_runner(cols, vals, x, acc, device=device)
    t0 = time.perf_counter()
    m_runner.run(m_state0())
    host_s = time.perf_counter() - t0
    np.testing.assert_allclose(np.asarray(m_sy.data).reshape(n), y, rtol=1e-5, atol=1e-5)
    mrow = m_runner.predicted_vs_measured()
    comp = np.median([r.compute_seconds for r in m_runner.records[:-1]])
    fetch = np.median([r.fetch_seconds for r in m_runner.records[:-1]])
    print(f"measured per-hyperstep (host loop, {host_s * 1e3:.1f}ms total, "
          f"{compiled_s and host_s / compiled_s:.1f}x slower than compiled): "
          f"compute {comp * 1e3:.2f}ms fetch {fetch * 1e3:.2f}ms -> "
          f"{'bandwidth' if fetch > comp else 'compute'}-heavy "
          f"(measured vote: "
          f"{'bandwidth' if mrow['bandwidth_heavy_measured'] else 'compute'})")
    return err


if __name__ == "__main__":
    main()
