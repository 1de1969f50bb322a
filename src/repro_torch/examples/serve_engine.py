"""Continuous-batching example: the ServeEngine draining a mixed workload.

Submits a handful of requests with different prompt lengths and generation
budgets, lets the engine pack them into segment-sized decode hypersteps
(one compiled replay per segment), and prints the lifecycle: Eq. 1-priced
admission decisions, per-segment occupancy, page-table churn, and the final
throughput/latency stats.

Run: python -m repro_torch.examples.serve_engine [--device cpu]
     (defaults to a smoke-sized attention arch; --lanes/--segment to resize)
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import model as M

__all__ = ["requests", "main"]


def requests(n: int, segment: int, vocab: int) -> list[tuple[np.ndarray, int]]:
    """``n`` (prompt, new tokens) pairs from seed 0: prompts of 4–16
    tokens, budgets of ``segment`` to 3·``segment`` − 1 tokens."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        prompt_len = int(rng.integers(4, 17))
        steps = int(rng.integers(segment, 3 * segment))
        out.append((rng.integers(0, vocab, size=prompt_len), steps))
    return out


def main(argv: list[str] | None = None) -> dict[int, np.ndarray]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_engine")
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--segment", type=int, default=8)
    ap.add_argument("--pool-seq", type=int, default=96)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' for the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)
    params = M.init_params(cfg, 0, device=device)
    eng = ServeEngine(cfg, params, max_lanes=args.lanes, pool_seq=args.pool_seq,
                      segment_len=args.segment, temperature=args.temperature, device=device)

    for i, (prompt, steps) in enumerate(requests(args.requests, args.segment, cfg.vocab_size)):
        rid = eng.submit(prompt, steps, seed=i)
        print(f"submit rid={rid} prompt={len(prompt)} tokens, gen={steps}")

    out = eng.run_until_drained()

    print("\nadmission decisions (Eq. 1 priced):")
    for a in eng.admission_log:
        print(f"  seg {a['segment']:>2}  rid {a['rid']}  B={a['occupancy_before']}"
              f"->{a['occupancy_before'] + a['admit']}  "
              f"predicted={a['verdict']:<15} measured={a['measured_verdict']:<15} "
              f"admit={a['admit']}")

    print("\nsegments:")
    for s in eng.segment_log:
        print(f"  seg {s['segment']:>2}  occupancy={s['occupancy']}  "
              f"{s['tokens']} tokens in {s['wall_seconds'] * 1e3:.1f}ms  "
              f"({s['tokens_per_s']:.0f} tok/s)")

    pages = eng.pool.table
    print(f"\npage table: {pages.num_pages} pages x {pages.page_tokens} tokens, "
          f"{len(pages.history)} assignments over the run "
          f"({pages.free_pages} free at drain)")

    stats = eng.stats()
    print(f"\n{stats['requests']} requests, {stats['tokens']} tokens, "
          f"{stats['tokens_per_s']:.0f} tok/s decode, "
          f"p50={stats['latency_p50_s'] * 1e3:.2f}ms "
          f"p99={stats['latency_p99_s'] * 1e3:.2f}ms per token, "
          f"mean occupancy {stats['mean_occupancy']:.1f}")
    first = min(out)
    print(f"rid {first} tokens: {out[first][:24].tolist()}")
    return out


if __name__ == "__main__":
    main()
