"""Serving launcher: batched autoregressive decoding as a BSPS program.

``python -m repro_torch.launch.serve --arch <id> [--smoke] --batch 4 --steps 32``

Prefill is a chunked pass — a loop of the decode step over ``block``-token
chunks of the prompt, block size autotuned under the local memory budget by
:func:`prefill_block_size` — then decode runs through
:class:`repro_torch.core.hyperstep.HyperstepRunner`: each generated token is
one hyperstep whose step samples from the resident logits and advances the
model, the KV cache is the persistent local state (a
:class:`~repro_torch.core.plan.ScratchSpec` in the plan), and the sampled
token ids are written *up* into a backing
:class:`~repro_torch.core.stream.Stream` — the serve path's write-back stream.

By default the decode is **compiled**: the runner replays all generated
tokens with no host sync in between (the runner is cached per request
shape, so repeated ``generate()`` calls reuse it). ``compiled=False`` keeps
the instrumented loop with one bulk sync and one record per token. Either
way the run is priced by :func:`repro_torch.core.plan.host_plan` and reports
its ``predicted_vs_measured()`` row; prefill and decode timings are reported
separately. Greedy decoding takes the argmax; sampling at a temperature uses
``torch.multinomial`` on a seeded generator, which cannot draw the JAX
package's ``jax.random.categorical`` numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.calibrate import default_machine
from repro_torch.core.hyperstep import HyperstepRecord, HyperstepRunner
from repro_torch.core.plan import ScratchSpec, StreamPlan, autotune, host_plan, streamed_operand
from repro_torch.core.stream import StreamSet
from repro_torch.core.trace import span, traced
from repro_torch.device import resolve_device
from repro_torch.launch.registry import Registry
from repro_torch.models import model as M
from repro_torch.train.steps import make_serve_step

__all__ = ["ServeStats", "make_prefill", "prefill_block_size", "compiled_serve_fns",
           "generate", "decode_runners"]


@dataclasses.dataclass
class ServeStats:
    """Timings + cost-model row for one :func:`generate` call.

    ``decode_seconds`` is per generated token in measure mode
    (``compiled=False``); in compiled mode it holds a single entry — the
    whole-run decode time.
    """

    prefill_seconds: float
    decode_seconds: list[float]
    records: list[HyperstepRecord]
    plan_row: dict[str, float] | None = None
    compiled: bool = False

    @property
    def decode_total_seconds(self) -> float:
        return float(sum(self.decode_seconds))


def make_prefill(cfg, block: int = 1, *, device: Any = None):
    """Chunked prefill: prompt -> (last-position logits, warm cache).

    A loop of the decode step over ``block``-token chunks of the prompt —
    identical cache contents to the per-token loop in ``ceil(S / block)``
    steps instead of ``S``. A prompt length that is not a multiple of
    ``block`` pays one leading partial chunk (``S mod block`` tokens) so the
    following chunks stay uniform. ``block > 1`` needs an attention-only
    stack (the recurrent mixers take one token per step). Pick the block
    with :func:`prefill_block_size`. The cache is written in place.
    """
    if block < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    if block > 1 and any(b.mixer != "attn" for b in cfg.pattern):
        raise ValueError(
            f"chunked prefill needs an attention-only stack; {cfg.name} "
            "has recurrent mixers (use block=1)")
    serve_step = make_serve_step(cfg, device=device)

    def prefill(params, cache, prompt):          # prompt: (B, S) int
        s = prompt.shape[1]
        lead = s % block or block                # partial chunk goes first
        logits, cache = serve_step(params, cache, {"tokens": prompt[:, :lead]})
        for start in range(lead, s, block):
            logits, cache = serve_step(params, cache,
                                       {"tokens": prompt[:, start:start + block]})
        return logits[:, -1:], cache

    return prefill


def _prefill_plan(cfg, batch: int, prompt_len: int, block: int) -> StreamPlan:
    """Eq. 1 plan for a chunked prefill: chunk down-stream + cache scratch."""
    return StreamPlan(
        name=f"prefill_{cfg.name}_b{block}",
        grid=(max(1, -(-prompt_len // block)),),
        inputs=(streamed_operand("chunk_embeds", batch * block * cfg.d_model),),
        outputs=(),
        scratch=(ScratchSpec("cache", (M.cache_bytes(cfg, batch, prompt_len),),
                             torch.int8),),
        dimension_semantics=("arbitrary",),
        # one forward over `block` positions: ~2 FLOPs/param/position
        flops_per_hyperstep=2.0 * M.count_params(cfg) * batch * block,
        supersteps_per_hyperstep=1.0,  # the per-chunk barrier — pricing it is
        # what makes bigger chunks win under Eq. 1
    )


@functools.lru_cache(maxsize=64)
def prefill_block_size(cfg, batch: int, prompt_len: int,
                       machine: BSPAccelerator | None = None, *,
                       device: Any = None) -> int:
    """Autotuned prefill chunk size for a request shape.

    Enumerates power-of-two blocks (plus the whole prompt) and picks the
    predicted-fastest plan that fits the machine's local memory
    (:func:`repro_torch.core.plan.autotune`): bigger blocks amortise the
    per-chunk barrier ``l``, the KV-cache scratch plus the chunk's
    double-buffered activations cap how big a block fits. Falls back to
    token-at-a-time when the stack has recurrent mixers or nothing fits.
    """
    if prompt_len <= 1 or any(b.mixer != "attn" for b in cfg.pattern):
        return 1
    machine = machine or default_machine(device=device)
    blocks = sorted({b for b in (1, 2, 4, 8, 16, 32, 64, 128, prompt_len)
                     if b <= prompt_len})
    try:
        best, _ = autotune(
            lambda block: _prefill_plan(cfg, batch, prompt_len, block),
            [{"block": b} for b in blocks], machine)
    except ValueError:       # not even block=1 fits L: stream token-at-a-time
        return 1
    return int(best.params["block"])


def compiled_serve_fns(cfg, temperature: float, *, device: Any = None):
    """(prefill, decode_fn) for a config: block-1 prefill and the decode step.

    ``decode_fn(params, logits, cache, gen) -> (tok, logits, cache, gen)``
    samples the next ids from the last logits (argmax at temperature 0) and
    advances the model by one token.
    """
    serve_step = make_serve_step(cfg, device=device)

    def decode_fn(params, logits, cache, gen):
        with span("repro_torch.serve.sample"):
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last.float() / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(last, dim=-1)
            tok = tok.to(torch.int32)[:, None]
        logits, cache = serve_step(params, cache, {"tokens": tok})
        return tok, logits, cache, gen

    return make_prefill(cfg, device=device), decode_fn


def _decode_plan(cfg, batch: int, max_len: int, generated):
    """Eq. 1 plan for a decode run: generated-id up-stream + cache scratch."""
    return host_plan(
        [], out_streams=[generated],
        # one forward pass per generated token: ~2 FLOPs/param/sequence
        flops_per_hyperstep=2.0 * M.count_params(cfg) * batch,
        scratch=(ScratchSpec("cache", (M.cache_bytes(cfg, batch, max_len),),
                             torch.int8),),
        name=f"serve_{cfg.name}",
    )


#: Compiled decode runners keyed by request shape, with refcounted eviction
#: (see :mod:`repro_torch.launch.registry`).
decode_runners = Registry(capacity=8)

#: each generate call's number, carried in its spans' arguments
_requests = itertools.count()


@traced("repro_torch.serve.build_runner")
def _build_decode_runner(cfg, temperature: float, batch: int, max_len: int,
                         steps: int, device: torch.device):
    """One compiled decode runner per request shape (the serving hot path).

    Params ride in the state, so weight updates need no rebuild. The runner
    and its ``generated`` backing stream are shared mutable state; the
    registry entry's lock serialises concurrent same-shape requests.
    """
    _, decode_fn = compiled_serve_fns(cfg, temperature, device=device)
    streams = StreamSet()
    generated = streams.create(np.zeros((steps, batch), np.int32), 1,
                               name="generated")

    def hyperstep(state, _tokens):
        params, logits, cache, gen = state
        tok, logits, cache, gen = decode_fn(params, logits, cache, gen)
        return (params, logits, cache, gen), [tok[:, 0]]

    runner = HyperstepRunner(
        hyperstep, [], out_streams=[generated], device=device,
        plan=_decode_plan(cfg, batch, max_len, generated))
    runner.compile(steps)
    return runner, generated


def generate(
    cfg,
    params,
    prompt_tokens,
    *,
    steps: int,
    temperature: float = 0.0,
    seed: int = 0,
    machine: BSPAccelerator | None = None,
    compiled: bool = True,
    max_len: int | None = None,
    prefill_block: int | None = None,
    device: Any = None,
) -> tuple[torch.Tensor, ServeStats]:
    """Generate ``steps`` tokens after ``prompt_tokens``; returns (tokens, stats).

    Runs on the CUDA card unless ``device="cpu"``; ``params`` must live on
    that device. ``compiled=True`` (default) replays the whole decode with no
    host sync per token; ``compiled=False`` is the instrumented loop with
    per-token records (measurement mode). ``max_len`` overrides the cache
    length (default ``prompt_len + steps``). ``prefill_block`` overrides the
    autotuned prefill chunk size (:func:`prefill_block_size`).

    Under a profiler the call is a ``repro_torch.serve.generate`` span
    (``request=<n>``, a number per call), holding ``serve.prefill`` (the
    bounds of ``prefill_seconds``), a ``serve.build_runner`` where no runner
    of the request's shape is cached, the runner's spans and, inside them,
    a ``serve.step`` a prefill chunk or token step and a ``serve.sample`` a
    generated token.
    """
    request = next(_requests)
    with span("repro_torch.serve.generate", request=request):
        device = M._on(params, device)
        prompt_tokens = torch.as_tensor(prompt_tokens).to(device, torch.int32)
        b, s = prompt_tokens.shape
        if s < 1:
            raise ValueError("need a non-empty prompt")
        if max_len is None:
            max_len = s + steps
        elif max_len < s + steps:
            raise ValueError(f"max_len={max_len} < prompt + steps = {s + steps}")
        cache = M.init_cache(cfg, b, max_len, device=device)

        machine = machine or default_machine(device=device)
        if prefill_block is None:
            prefill_block = prefill_block_size(cfg, b, s, machine)
        prefill = make_prefill(cfg, prefill_block, device=device)
        _, decode_fn = compiled_serve_fns(cfg, temperature, device=device)

        # -- prefill -----------------------------------------------------------
        t0 = time.perf_counter()
        with span("repro_torch.serve.prefill", request=request):
            logits, cache = prefill(params, cache, prompt_tokens)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        prefill_s = time.perf_counter() - t0

        gen = torch.Generator(device=device)
        gen.manual_seed(seed)

        if compiled:
            # -- decode: the whole run replayed with no per-token host sync ----
            with decode_runners.acquire(
                    (cfg, temperature, b, max_len, steps, str(device)),
                    lambda: _build_decode_runner(cfg, temperature, b, max_len,
                                                 steps, device)) as entry:
                runner, generated = entry.value
                with entry.lock:            # cached runner + stream are shared
                    runner.machine = machine
                    runner.reset_records()  # per-request row, program stays cached
                    runner.run((params, logits, cache, gen), compiled=True)
                    decode_seconds = [runner.records[-1].step_seconds]
                    generated_ids = np.array(generated.data, np.int32)
                    records = list(runner.records)
                    plan_row = runner.predicted_vs_measured()
        else:
            # -- decode: one instrumented hyperstep per generated token --------
            streams = StreamSet()
            generated = streams.create(np.zeros((steps, b), np.int32), 1,
                                       name="generated")

            def hyperstep(state, _tokens):
                logits, cache, gen = state
                tok, logits, cache, gen = decode_fn(params, logits, cache, gen)
                # the sampled ids stream up; the DMA lane copies them to the
                # host off the compute path
                return (logits, cache, gen), [tok[:, 0]]

            runner = HyperstepRunner(
                hyperstep, [], out_streams=[generated], device=device,
                plan=_decode_plan(cfg, b, max_len, generated), machine=machine)
            runner.run((logits, cache, gen))
            decode_seconds = [r.compute_seconds for r in runner.records]
            generated_ids = np.array(generated.data, np.int32)
            records = list(runner.records)
            plan_row = runner.predicted_vs_measured()

        out = torch.cat(
            [prompt_tokens, torch.from_numpy(generated_ids).T.to(device)], dim=1)
        stats = ServeStats(
            prefill_seconds=prefill_s,
            decode_seconds=decode_seconds,
            records=records,
            plan_row=plan_row,
            compiled=compiled,
        )
        return out, stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain versions")
    ap.add_argument("--measure", action="store_true",
                    help="instrumented per-token decode loop instead of the "
                         "compiled replay")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = M.init_params(cfg, 0, device=device)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g)
    tokens, stats = generate(cfg, params, prompt, steps=args.steps,
                             temperature=args.temperature,
                             compiled=not args.measure, device=device)
    total = stats.decode_total_seconds
    print(f"[serve] arch={args.arch} batch={args.batch} device={device} "
          f"prefill={stats.prefill_seconds * 1e3:.1f}ms ({args.prompt_len} tokens) | "
          f"decode={args.steps} tok in {total * 1e3:.1f}ms "
          f"throughput={args.steps * args.batch / total:.1f} tok/s")
    row = stats.plan_row or {}
    if row:
        print(f"[predicted_vs_measured] pred={row['predicted_seconds']:.4g}s "
              f"meas={row['measured_seconds']:.4g}s "
              f"ratio={row['pred_over_meas']:.3g} "
              f"bw_heavy pred={row['bandwidth_heavy_predicted']:.0f} "
              f"meas={row['bandwidth_heavy_measured']:.0f}")
    print("sample row:", tokens[0, : args.prompt_len + 8].tolist())


if __name__ == "__main__":
    main()
