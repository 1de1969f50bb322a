"""Continuous-batching serve engine: packed decode hypersteps on the BSPS runtime.

The serving tier above :mod:`repro_torch.launch.serve`. Instead of one decode
run per request, a :class:`ServeEngine` packs up to ``max_lanes`` concurrent
requests of mixed prompt lengths into one batched decode program and runs it
in **segments**: each segment is ``segment_len`` packed hypersteps replayed
by one compiled :class:`~repro_torch.core.hyperstep.HyperstepRunner` program
(built once, replayed every segment, with no host sync between its
hypersteps), and requests join or retire only at segment boundaries — the
batch axis stays ``max_lanes`` wide and an ``active`` mask in the state turns
lanes on and off, so occupancy changes never rebuild the program.

Admission is priced, not guessed: before packing lane ``B+1`` the engine
builds Eq. 1 plans for ``B`` and ``B+1`` lanes
(:func:`repro_torch.core.plan.packed_decode_plan`) and admits only while the
packed step is predicted to stay compute-bound
(:func:`repro_torch.core.plan.admission_decision`) — the BSF scalability
boundary applied per request. Each segment then reports the runner's
``predicted_vs_measured()`` row, so every admission verdict can be checked
against the measured one.

The KV pool is paged, and it is *plan scratch*: one dense cache of
``max_lanes × pool_seq`` positions (declared to the cost model via
:func:`repro_torch.core.plan.batched_scratch`) fronted by a
:class:`BlockTable` that accounts pages. Allocation and eviction never copy
keys/values around — retiring a request frees its pages and resets the lane's
length cursor to 0 (cursor replay, the MOVE-style non-injective reuse of §4:
the same physical rows serve a different request id next join; the stale
values are hidden by the per-lane validity masks).

Each lane's generated ids ride their own write-back stream
(:meth:`repro_torch.core.stream.StreamSet.create_lanes`), scattered on the
device by the compiled program and harvested at the segment boundary.

The engine is the JAX package's, on torch tensors. Greedy decoding gives its
token ids. Sampling draws from one seeded ``torch.Generator`` per lane, on
the engine's device, reseeded with the request's seed when it joins — so a
request's samples do not depend on the other lanes, as with the JAX
package's per-lane keys, but they cannot be its numbers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.core.bsp import BSPAccelerator
from repro_torch.core.calibrate import default_machine
from repro_torch.core.calibstore import get_default_store, plan_band
from repro_torch.core.faults import FaultInjected
from repro_torch.core.health import HealthMonitor
from repro_torch.core.hyperstep import HyperstepRunner
from repro_torch.core.plan import (
    admission_decision,
    batched_scratch,
    packed_decode_plan,
)
from repro_torch.core.stream import StreamSet
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prefill, prefill_block_size
from repro_torch.models import model as M
from repro_torch.train.steps import make_serve_step

__all__ = ["BlockTable", "PagedKVPool", "Request", "ServeEngine"]

# Health and degradation settings, the JAX engine's defaults: the SLO
# baseline is the median of the first SLO_WARMUP segments; DEGRADE_AFTER
# consecutive SLO-violating segments enter degraded mode (BSPS208) and
# RECOVER_AFTER consecutive healthy ones leave it (BSPS209); drift (BSPS220)
# is the median predicted/measured ratio of the last DRIFT_WINDOW segments
# leaving DRIFT_BAND x baseline.
SLO_WARMUP = 2
DEGRADE_AFTER = 2
RECOVER_AFTER = 2
DRIFT_BAND = (0.5, 2.0)
DRIFT_WINDOW = 4


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One submitted generation request and its lifecycle state."""

    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int
    seed: int = 0
    deadline_s: float | None = None     # wall budget from submit; None = none

    lane: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    prefill_seconds: float = 0.0
    submit_time: float = 0.0
    join_time: float | None = None
    done_time: float | None = None
    timed_out: bool = False
    cancelled: bool = False

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def tokens(self) -> np.ndarray:
        """prompt ++ generated, the same layout :func:`serve.generate` returns."""
        return np.concatenate(
            [self.prompt.astype(np.int32),
             np.asarray(self.generated[: self.max_new_tokens], np.int32)])


# ---------------------------------------------------------------------------
# Paged KV accounting
# ---------------------------------------------------------------------------


class BlockTable:
    """Page accounting for the KV pool: which request owns which page.

    Pure bookkeeping — the physical rows live in :class:`PagedKVPool`'s dense
    cache; the table decides whether a request's working set *fits* and
    records the page → request map. The map is deliberately non-injective
    over time: :meth:`free` returns pages to the pool and the next
    :meth:`alloc` hands the same physical pages to a different request —
    ``history`` keeps the full (page, rid) assignment trail.
    """

    def __init__(self, num_pages: int, page_tokens: int):
        if num_pages < 1 or page_tokens < 1:
            raise ValueError("need num_pages >= 1 and page_tokens >= 1")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self._free: list[int] = list(range(num_pages))[::-1]
        self.owner: dict[int, int] = {}          # page -> rid
        self.history: list[tuple[int, int]] = []  # (page, rid) assignments

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.page_tokens)

    def can_alloc(self, tokens: int) -> bool:
        return self.pages_for(tokens) <= self.free_pages

    def alloc(self, rid: int, tokens: int) -> list[int] | None:
        """Claim pages for ``tokens`` positions, or None if the pool is full."""
        n = self.pages_for(tokens)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.owner[p] = rid
            self.history.append((p, rid))
        return pages

    def free(self, rid: int) -> int:
        """Release every page owned by ``rid``; returns how many were freed."""
        pages = [p for p, r in self.owner.items() if r == rid]
        for p in pages:
            del self.owner[p]
            self._free.append(p)
        return len(pages)


class PagedKVPool:
    """The packed batch's KV state: a dense lane pool + page accounting.

    ``cache`` is one model cache of ``max_lanes`` lanes × ``pool_seq``
    positions with a *vector* ``len`` (one decode position per lane — the
    mixed-prompt-length path of
    :func:`repro_torch.models.attention.attention_decode`). Joining a request
    copies its prefilled batch-1 cache into a free lane (the only copy in a
    request's lifetime); retiring frees the lane and pages and resets the
    lane's ``len`` to 0 — eviction is cursor replay, not data movement.
    """

    def __init__(self, cfg, max_lanes: int, pool_seq: int, *,
                 page_tokens: int = 8, num_pages: int | None = None,
                 faults: Any | None = None, device: Any = None):
        self.faults = faults
        self.cfg = cfg
        self.max_lanes = int(max_lanes)
        self.pool_seq = int(pool_seq)
        self.device = resolve_device(device)
        cache = M.init_cache(cfg, max_lanes, pool_seq, device=self.device)
        cache["len"] = torch.zeros((max_lanes,), dtype=torch.int32, device=self.device)
        self.cache = cache
        if num_pages is None:       # fully provisioned: pages never bind
            num_pages = max_lanes * (-(-pool_seq // page_tokens))
        self.table = BlockTable(num_pages, page_tokens)
        self._free_lanes = list(range(max_lanes))[::-1]

    @property
    def free_lanes(self) -> int:
        return len(self._free_lanes)

    def lane_lens(self) -> np.ndarray:
        return self.cache["len"].cpu().numpy().astype(np.int32)

    def can_admit(self, tokens: int) -> bool:
        """Admission pre-check: a free lane, enough pages, and no injected
        exhaustion (an injected ``page_exhaust`` fault makes the pool report
        full for this one consultation)."""
        if self.faults is not None and self.faults.page_fault():
            return False
        return bool(self._free_lanes) and self.table.can_alloc(tokens)

    def try_admit(self, rid: int, tokens: int) -> tuple[int, list[int]] | None:
        """Claim a lane + pages for ``tokens`` positions, or None if full."""
        if not self._free_lanes:
            return None
        pages = self.table.alloc(rid, tokens)
        if pages is None:
            return None
        return self._free_lanes.pop(), pages

    def join(self, lane: int, req_cache: dict[str, Any]) -> None:
        """Copy a prefilled batch-1 cache (``pool_seq`` positions) into a lane."""
        _scatter_lane(self.cache, req_cache, lane)

    def retire(self, rid: int, lane: int) -> None:
        """Free the request's pages + lane; reset the lane's length cursor."""
        self.table.free(rid)
        self.cache["len"][lane] = 0
        self._free_lanes.append(lane)

    def reset_inactive(self, active: np.ndarray) -> None:
        """Zero the length cursor of every inactive lane.

        Inactive lanes still step through the packed program (masked to token
        0), growing their ``len`` by ``segment_len`` per segment; resetting at
        the boundary keeps the junk bounded and the next join starts the lane
        from position 0 over the same physical rows.
        """
        keep = torch.as_tensor(active, device=self.device)
        self.cache["len"].masked_fill_(~keep, 0)


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _scatter_lane(pool: dict[str, Any], req: dict[str, Any], lane: int) -> None:
    """Copy a batch-1 cache into row ``lane`` of the pool's cache, in place:
    every layer tensor (batch first) and ``len[lane]``."""
    for p, r in zip(_tensors(pool["layers"]), _tensors(req["layers"])):
        p[lane].copy_(r[0])
    pool["len"][lane] = req["len"]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class ServeEngine:
    """Continuous-batching decode over packed hypersteps with priced admission.

    Parameters
    ----------
    cfg, params:
        The model (attention-only stacks — the per-lane length vector rides
        the generalised :func:`repro_torch.models.model.decode_step`).
        ``params`` live on ``device``.
    max_lanes:
        Packed batch width. The compiled program is built once at this
        width; occupancy changes only flip the ``active`` mask.
    pool_seq:
        KV positions per lane. A request needs ``prompt_len`` plus its
        generation rounded up to whole segments.
    segment_len:
        Hypersteps per segment — the join/retire granularity. One segment =
        one compiled replay with a bulk sync at its end.
    page_tokens / num_pages:
        Paged-pool geometry (see :class:`PagedKVPool`). Passing fewer pages
        than ``max_lanes × pool_seq/page_tokens`` oversubscribes the pool, so
        admission can refuse on pages even with a free lane.
    temperature:
        0 = greedy (the packed-vs-sequential equivalence mode); > 0 samples
        per lane from a per-lane generator seeded with the request's seed.
    faults:
        Optional :class:`~repro_torch.core.faults.FaultInjector` threaded
        through the runner (dispatch failures, stalls, corruption) and the
        page pool (injected exhaustion).
    slo_band:
        The Eq. 1 SLO band the :class:`~repro_torch.core.health.HealthMonitor`
        scores each segment against (relative to the warmup baseline ratio).
        ``DEGRADE_AFTER`` consecutive SLO-violating segments enter degraded
        mode (admissions shed while lanes are busy; admission re-priced
        against the measured slowdown, BSPS208), ``RECOVER_AFTER``
        consecutive healthy segments exit it (BSPS209).
    dispatch_retries / retry_backoff_s:
        Bounded retry on a failed segment dispatch (simulated preemption):
        up to ``dispatch_retries`` retries with exponential backoff (BSPS204)
        before the failure propagates out of :meth:`step_segment` (BSPS211).
    calibstore:
        Where measured segments land and where drift refits come from.
        ``None`` uses the process default store, a
        :class:`~repro_torch.core.calibstore.CalibrationStore` isolates this
        engine, ``False`` disables recording *and* recalibration. On
        BSPS220 drift (see ``DRIFT_BAND``) the engine refits (g, l, e) from
        the store for the current decode plan's band, adopts the refit pack
        for prediction *and* admission pricing (BSPS221), and re-prices the
        pending admission. No usable fit → BSPS222.
    device:
        Where the engine runs; ``None`` means the CUDA card (and raises
        without one), ``"cpu"`` runs the kernels' plain versions.
    """

    def __init__(self, cfg, params, *, max_lanes: int = 4,
                 pool_seq: int = 128, segment_len: int = 8,
                 page_tokens: int = 8, num_pages: int | None = None,
                 temperature: float = 0.0,
                 machine: BSPAccelerator | None = None,
                 faults: Any | None = None,
                 slo_band: tuple[float, float] = (0.05, 20.0),
                 dispatch_retries: int = 3, retry_backoff_s: float = 0.01,
                 calibstore: Any | None = None,
                 device: Any = None):
        if any(b.mixer != "attn" for b in cfg.pattern):
            raise ValueError(
                f"ServeEngine needs an attention-only stack; {cfg.name} has "
                "recurrent mixers (serve them through generate())")
        if segment_len < 1 or max_lanes < 1:
            raise ValueError("need segment_len >= 1 and max_lanes >= 1")
        if pool_seq < segment_len:
            raise ValueError(f"pool_seq={pool_seq} < segment_len={segment_len}")
        self.device = M._on(params, device)
        self.cfg = cfg
        self.params = params
        self.max_lanes = int(max_lanes)
        self.pool_seq = int(pool_seq)
        self.segment_len = int(segment_len)
        self.temperature = float(temperature)
        self.machine = machine or default_machine(device=self.device)
        # the pack predictions and admissions are priced on *right now*:
        # self.machine until a drift refit is adopted (then BSPS221 swaps it)
        self.active_machine = self.machine
        if calibstore is None:
            calibstore = get_default_store()
        self.calibstore = calibstore if calibstore is not False else None
        self.faults = faults
        self.health = HealthMonitor(band=slo_band, warmup=SLO_WARMUP,
                                    name=f"engine_{cfg.name}",
                                    drift_band=DRIFT_BAND,
                                    drift_window=DRIFT_WINDOW)
        self.degraded = False
        self._dispatch_retries = int(dispatch_retries)
        self._retry_backoff_s = float(retry_backoff_s)
        self._slo_scale = 1.0        # measured slowdown while degraded

        self.pool = PagedKVPool(cfg, max_lanes, pool_seq,
                                page_tokens=page_tokens, num_pages=num_pages,
                                faults=faults, device=self.device)
        self.queue: deque[Request] = deque()
        self.running: dict[int, Request] = {}     # rid -> request (has a lane)
        self.finished: dict[int, Request] = {}
        self.admission_log: list[dict[str, Any]] = []
        self.segment_log: list[dict[str, Any]] = []
        self.token_latencies: list[float] = []    # seconds/token, every token
        self._next_rid = 0
        self._segments_run = 0

        self._logits = torch.zeros((max_lanes, 1, cfg.vocab_size), dtype=torch.float32,
                                   device=self.device)
        self._gens = [torch.Generator(device=self.device) for _ in range(max_lanes)]
        for i, g in enumerate(self._gens):
            g.manual_seed(i)
        self._active = np.zeros((max_lanes,), bool)

        # per-lane generated-id up-streams + the one compiled segment program
        self._streams = StreamSet()
        self.lane_streams = self._streams.create_lanes(
            self.segment_len, max_lanes, name="lane")
        # each segment is statically checked before dispatch
        # (lane-aliased up-streams, cursor overruns); results are memoized
        # per cursor state, so steady-state segments — which rewind the same
        # lane cursors — pay one set lookup, not a re-walk
        self._runner = HyperstepRunner(
            self._make_step(), [], out_streams=self.lane_streams,
            machine=self.machine, verify=True, faults=faults,
            health=self.health,
            calibstore=self.calibstore if self.calibstore is not None
            else False, device=self.device)
        self._runner.compile(self.segment_len)

        # Eq. 1 bookkeeping for the admission plans (the JAX package's cache
        # bytes: K/V of every layer plus its int32 length scalar)
        cache_bytes = M.cache_bytes(cfg, max_lanes, pool_seq)
        self._bytes_per_lane = cache_bytes // max_lanes
        self._kv_words_per_pos = (cache_bytes / 4) / (max_lanes * pool_seq)
        self._param_words = M.count_params(cfg)

    # -- the packed hyperstep -------------------------------------------------

    def _make_step(self):
        serve_step = make_serve_step(self.cfg, device=self.device)
        temperature = self.temperature
        lanes = self.max_lanes

        def step(state, _tokens):
            params, logits, cache, gens, active = state
            last = logits[:, -1]
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                # one generator per lane: a lane's draws depend on its own
                # request's seed only
                tok = torch.cat([torch.multinomial(probs[i], 1, generator=gens[i])
                                 for i in range(lanes)])
            else:
                tok = torch.argmax(last, dim=-1)
            # masked lanes decode token 0 — junk the boundary discards
            tok = torch.where(active, tok, torch.zeros_like(tok)).to(torch.int32)
            logits, cache = serve_step(params, cache, {"tokens": tok[:, None]})
            # logits are kept in fp32 (argmax is unchanged by the upcast)
            state = (params, logits.float(), cache, gens, active)
            return state, [tok[i] for i in range(lanes)]

        return step

    # -- admission ------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, seed: int = 0,
               deadline_s: float | None = None) -> int:
        """Queue a request; returns its rid. Joins at a segment boundary.

        ``deadline_s`` is a wall-clock budget from submission: a request
        still unfinished when it expires is retired at the next segment
        boundary (``timed_out=True``, BSPS205) with whatever tokens it has.
        """
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("need a non-empty prompt")
        need = prompt.size + self._scheduled_steps(max_new_tokens)
        if need > self.pool_seq:
            raise ValueError(
                f"request needs {need} positions (prompt {prompt.size} + "
                f"{self._scheduled_steps(max_new_tokens)} scheduled steps) "
                f"> pool_seq={self.pool_seq}")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                      seed=seed, deadline_s=deadline_s,
                      submit_time=time.perf_counter())
        self.queue.append(req)
        return rid

    def _scheduled_steps(self, max_new_tokens: int) -> int:
        """Generation rounded up to whole segments (retire is boundary-only)."""
        segs = -(-int(max_new_tokens) // self.segment_len)
        return segs * self.segment_len

    def _occupancy(self) -> int:
        return len(self.running)

    def _decode_plan(self, lanes: int, extra_len: int = 0):
        """Eq. 1 plan for one segment at ``lanes`` occupancy.

        The KV working set per lane is the mean active position (plus the
        incoming request's prompt when pricing a candidate) advanced half a
        segment — the streamed-per-step traffic that grows with occupancy
        and length, against the shared params stream and barrier that
        batching amortises.
        """
        lens = self.pool.lane_lens()[self._active]
        total = float(lens.sum()) + float(extra_len)
        mean_len = total / max(lanes, 1)
        kv_pos = min(self.pool_seq, mean_len + self.segment_len / 2)
        return packed_decode_plan(
            lanes=lanes,
            steps=self.segment_len,
            flops_per_token=2.0 * self._param_words,
            params_words=self._param_words,
            kv_words_per_lane=self._kv_words_per_pos * kv_pos,
            scratch=(batched_scratch("kv_pool", self._bytes_per_lane,
                                     self.max_lanes),),
            name=f"engine_{self.cfg.name}_B{lanes}",
        )

    def _admission_machine(self) -> BSPAccelerator:
        """The machine admission prices against.

        Three packs, in order of preference: an adopted calibration-store
        refit (BSPS221 — measured (g, l, e), the drift priced where it
        actually lives), else the fixed degraded-mode derate (BSPS208 — the
        measured slowdown folded into the compute rate), else the calibrated
        original.
        """
        if self.active_machine is not self.machine:
            return self.active_machine     # refit pack carries the drift
        if not self.degraded or self._slo_scale <= 1.0:
            return self.machine
        return dataclasses.replace(
            self.machine, r=self.machine.r / self._slo_scale)

    def _machine_pack_label(self) -> str:
        """Which pack :meth:`_admission_machine` is returning right now."""
        if self.active_machine is not self.machine:
            return "refit"
        if self.degraded and self._slo_scale > 1.0:
            return "derated"
        return "calibrated"

    def _try_join(self) -> None:
        """Admit queued requests while Eq. 1 says one more lane still pays.

        In degraded mode admissions are shed entirely while any lane is busy
        (an idle engine still serves — there is nothing left to protect).
        """
        while self.queue:
            req = self.queue[0]
            occupancy = self._occupancy()
            if self.degraded and occupancy > 0:
                break                      # shedding until the SLO recovers
            if self.pool.free_lanes == 0:
                break
            need = req.prompt_len + self._scheduled_steps(req.max_new_tokens)
            if not self.pool.can_admit(need):
                self.health.emit(
                    "BSPS207", f"page pool exhausted; request {req.rid} "
                    f"deferred (needs {need} positions)", index=req.rid)
                break                      # page pressure: defer (FCFS)
            current = self._decode_plan(occupancy) if occupancy else None
            candidate = self._decode_plan(occupancy + 1,
                                          extra_len=req.prompt_len)
            dec = admission_decision(
                current, candidate, self._admission_machine(),
                tokens_per_hyperstep=occupancy + 1)
            self.admission_log.append({
                "rid": req.rid, "segment": self._segments_run,
                "occupancy_before": occupancy,
                "measured_verdict": None,       # filled by the next segment
                "machine_pack": self._machine_pack_label(),
                "repriced": False,
                **dec.row(),
            })
            if not dec.admit:
                break                      # bandwidth boundary: defer
            self.queue.popleft()
            self._join(req)

    def _join(self, req: Request) -> None:
        claim = self.pool.try_admit(req.rid, req.prompt_len
                                    + self._scheduled_steps(req.max_new_tokens))
        assert claim is not None           # _try_join checked both resources
        lane, _pages = claim
        req.lane = lane

        # batch-1 chunked prefill at the pool's geometry, then one copy into
        # the lane — the only copy in the request's lifetime
        block = prefill_block_size(self.cfg, 1, req.prompt_len, self.machine)
        prefill = make_prefill(self.cfg, block, device=self.device)
        cache = M.init_cache(self.cfg, 1, self.pool_seq, device=self.device)
        prompt = torch.as_tensor(req.prompt[None, :]).to(self.device, torch.int32)
        t0 = time.perf_counter()
        logits, cache = prefill(self.params, cache, prompt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        req.prefill_seconds = time.perf_counter() - t0

        self.pool.join(lane, cache)
        self._logits[lane] = logits[0].float()
        self._gens[lane].manual_seed(req.seed)
        self._active[lane] = True
        req.join_time = time.perf_counter()
        self.running[req.rid] = req

    # -- request lifecycle (retire / cancel / deadlines) ----------------------

    def _retire(self, req: Request) -> None:
        """Free a running request's lane + pages and move it to finished."""
        self.pool.retire(req.rid, req.lane)
        self._active[req.lane] = False
        del self.running[req.rid]
        self.finished[req.rid] = req

    def cancel(self, rid: int) -> bool:
        """Cancel a request; returns True if it was queued or running.

        A running request's lane and pages are reclaimed *immediately* — the
        lane drops out of the active mask, so the next segment decodes
        nothing for it and a queued request can join in its place at the
        next boundary. The request lands in ``finished`` with
        ``cancelled=True`` and whatever tokens it had harvested.
        """
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                req.cancelled = True
                req.done_time = time.perf_counter()
                self.finished[rid] = req
                self.health.emit("BSPS206", f"request {rid} cancelled while "
                                 "queued", index=rid)
                return True
        req = self.running.get(rid)
        if req is not None:
            req.cancelled = True
            req.done_time = time.perf_counter()
            self._retire(req)
            self.health.emit("BSPS206", f"request {rid} cancelled; lane "
                             f"{req.lane} and pages reclaimed", index=rid)
            return True
        return False

    def _expire_deadlines(self) -> None:
        """Retire requests whose wall budget ran out (BSPS205).

        Runs at segment boundaries — the packed segment is never interrupted
        midway, matching the bulk-synchronous contract.
        """
        now = time.perf_counter()

        def expired(req: Request) -> bool:
            return (req.deadline_s is not None
                    and now - req.submit_time > req.deadline_s)

        for req in list(self.queue):
            if expired(req):
                self.queue.remove(req)
                req.timed_out = True
                req.done_time = now
                self.finished[req.rid] = req
                self.health.emit(
                    "BSPS205", f"request {req.rid} expired in queue after "
                    f"{req.deadline_s}s", index=req.rid)
        for req in list(self.running.values()):
            if not req.done and expired(req):
                req.timed_out = True
                req.done_time = now
                self._retire(req)
                self.health.emit(
                    "BSPS205", f"request {req.rid} exceeded deadline "
                    f"{req.deadline_s}s with {len(req.generated)}/"
                    f"{req.max_new_tokens} tokens; retired", index=req.rid)

    # -- the segment loop -----------------------------------------------------

    def _dispatch_segment(self, state: Any) -> Any:
        """One segment dispatch under bounded retry-with-backoff.

        An injected dispatch failure (simulated preemption) raises from the
        runner *before* any state or cursor moves, so the retry re-runs the
        identical segment. Retries exhausted → BSPS211 and the failure
        propagates to the caller.
        """
        for attempt in range(self._dispatch_retries + 1):
            try:
                return self._runner.run(state, self.segment_len, compiled=True)
            except FaultInjected as e:
                self.health.emit(
                    "BSPS204", f"segment {self._segments_run} dispatch failed "
                    f"(attempt {attempt + 1}): {e.record.kind}",
                    index=self._segments_run)
                if attempt >= self._dispatch_retries:
                    self.health.emit(
                        "BSPS211", f"segment {self._segments_run} dispatch "
                        f"retries exhausted after {attempt + 1} attempts",
                        index=self._segments_run)
                    raise
                time.sleep(self._retry_backoff_s * (2 ** attempt))

    def _update_degradation(self) -> None:
        """The BSPS208/209 state machine, stepped once per segment."""
        if (not self.degraded
                and self.health.consecutive_violations >= DEGRADE_AFTER):
            self.degraded = True
            self._slo_scale = max(
                self.health.last_ratio
                / max(self.health.baseline_ratio, 1e-12), 1.0)
            self.health.emit(
                "BSPS208", f"{self.health.consecutive_violations} consecutive "
                f"SLO violations (last {self._slo_scale:.3g}x baseline); "
                "shedding admissions and re-pricing the decode plan",
                index=self._segments_run - 1, value=self._slo_scale)
        elif (self.degraded
                and self.health.consecutive_healthy >= RECOVER_AFTER):
            self.degraded = False
            self._slo_scale = 1.0
            self.health.emit(
                "BSPS209", f"SLO recovered after "
                f"{self.health.consecutive_healthy} healthy segments; "
                "admissions resume", index=self._segments_run - 1)

    def _maybe_recalibrate(self) -> None:
        """Consume a pending drift event: refit, adopt, re-price.

        The HealthMonitor queues a :class:`RecalibrationEvent` when the
        median predicted/measured ratio of recent segments leaves the drift
        band (BSPS220). Refit (g, l, e) from the calibration store's most
        recent ``drift_window`` records for the current decode plan's band —
        exactly the segments whose sustained shift fired the detector —,
        adopt the refit pack for the runner's predictions and the admission
        pricing (BSPS221), rebaseline the SLO scorer on it, and re-price the
        pending admission so the next segment's measurement confirms the
        refit verdict. No store, or an under-evidenced / low-confidence fit,
        keeps the original pack (BSPS222).
        """
        event = self.health.pop_recalibration()
        if event is None:
            return
        seg = self._segments_run - 1
        if self.calibstore is None:
            self.health.emit(
                "BSPS222", "calibration drift detected but recording is "
                f"disabled; nothing to refit from (ratio {event.ratio:.3g}x "
                "baseline)", index=seg, value=event.ratio)
            return
        band = plan_band(self._runner.plan)
        refit = self.calibstore.refit_machine(
            self.machine, band=band, window=self.health.drift_window,
            device=self.device)
        if refit is None:
            self.health.emit(
                "BSPS222", f"calibration drift (ratio {event.ratio:.3g}x "
                f"baseline) but band {band} is under-evidenced; keeping the "
                "closed-form pack", index=seg, value=event.ratio)
            return
        self.active_machine = refit
        self._runner.machine = refit
        self.health.rebaseline()
        self.health.emit(
            "BSPS221", f"adopted calibration-store refit for band {band}: "
            f"g {self.machine.g:.3g}->{refit.g:.3g}, "
            f"l {self.machine.l:.3g}->{refit.l:.3g}, "
            f"e {self.machine.e:.3g}->{refit.e:.3g}; admission re-priced",
            index=seg, value=refit.e / max(self.machine.e, 1e-12))
        self._reprice_admission()

    def _reprice_admission(self) -> None:
        """Log a fresh admission verdict priced on the refit pack.

        The head-of-queue request (or, with an empty queue, the standing
        occupancy) is priced again through :func:`admission_decision` on
        :meth:`_admission_machine` and logged with ``repriced=True``; the
        next segment fills ``measured_verdict`` like any admission row.
        """
        occupancy = self._occupancy()
        if occupancy == 0 and not self.queue:
            return
        if self.queue:
            req = self.queue[0]
            current = self._decode_plan(occupancy) if occupancy else None
            candidate = self._decode_plan(occupancy + 1,
                                          extra_len=req.prompt_len)
            rid, tokens = req.rid, occupancy + 1
        else:
            # no queue: re-price the standing batch itself (candidate-only
            # form — the verdict side of Eq. 1's max, no join policy)
            current, candidate = None, self._decode_plan(occupancy)
            rid, tokens = -1, occupancy
        dec = admission_decision(current, candidate,
                                 self._admission_machine(),
                                 tokens_per_hyperstep=tokens)
        self.admission_log.append({
            "rid": rid, "segment": self._segments_run,
            "occupancy_before": occupancy,
            "measured_verdict": None,       # filled by the next segment
            "machine_pack": self._machine_pack_label(),
            "repriced": True,
            **dec.row(),
        })

    def step_segment(self) -> int:
        """Run one packed segment; returns tokens harvested for real requests."""
        self._expire_deadlines()
        self._try_join()
        occupancy = self._occupancy()
        if occupancy == 0:
            return 0

        self._runner.plan = self._decode_plan(occupancy)
        self._runner.reset_records()
        state = (self.params, self._logits, self.pool.cache, self._gens,
                 torch.as_tensor(self._active).to(self.device))
        state = self._dispatch_segment(state)
        _, self._logits, cache, self._gens, _ = state
        self.pool.cache = dict(cache)
        wall = self._runner.records[-1].step_seconds
        row = self._runner.predicted_vs_measured()
        measured = ("bandwidth_heavy" if row["bandwidth_heavy_measured"]
                    else "compute_bound")
        for entry in self.admission_log:
            if entry["measured_verdict"] is None:
                entry["measured_verdict"] = measured
        self._segments_run += 1

        # harvest each lane's up-stream, retire satisfied requests
        harvested = 0
        per_token = wall / self.segment_len
        for req in list(self.running.values()):
            data = np.asarray(self.lane_streams[req.lane].data, np.int32)
            take = min(self.segment_len,
                       req.max_new_tokens - len(req.generated))
            # corruption gate: a bit-flipped id is out of vocab range
            self.health.check_output(
                data[:take], lo=0, hi=self.cfg.vocab_size,
                source=f"lane{req.lane}", index=self._segments_run - 1)
            req.generated.extend(int(t) for t in data[:take])
            harvested += take
            self.token_latencies.extend([per_token] * take)
            if req.done:
                req.done_time = time.perf_counter()
                self._retire(req)
        self.pool.reset_inactive(self._active)
        self._update_degradation()
        self._maybe_recalibrate()
        self._expire_deadlines()

        self.segment_log.append({
            "segment": self._segments_run - 1,
            "occupancy": occupancy,
            "wall_seconds": wall,
            "tokens": harvested,
            "tokens_per_s": harvested / max(wall, 1e-12),
            **row,
        })
        return harvested

    def run_until_drained(self, max_segments: int = 10_000) -> dict[int, np.ndarray]:
        """Run segments until queue + lanes are empty; returns rid -> tokens."""
        for _ in range(max_segments):
            if not self.queue and not self.running:
                break
            self.step_segment()
        else:
            raise RuntimeError(
                f"engine not drained after {max_segments} segments "
                f"({len(self.queue)} queued, {len(self.running)} running)")
        return {rid: r.tokens() for rid, r in sorted(self.finished.items())}

    # -- reporting ------------------------------------------------------------

    def stats(self) -> dict[str, Any]:
        lat = np.asarray(self.token_latencies or [0.0])
        decode_s = sum(s["wall_seconds"] for s in self.segment_log)
        tokens = sum(s["tokens"] for s in self.segment_log)
        return {
            "requests": len(self.finished),
            "segments": self._segments_run,
            "tokens": tokens,
            "decode_seconds": decode_s,
            "tokens_per_s": tokens / max(decode_s, 1e-12),
            "latency_p50_s": float(np.percentile(lat, 50)),
            "latency_p99_s": float(np.percentile(lat, 99)),
            "mean_occupancy": (
                float(np.mean([s["occupancy"] for s in self.segment_log]))
                if self.segment_log else 0.0),
            "admissions": len(self.admission_log),
            "admission_verdict_matches": sum(
                1 for a in self.admission_log
                if a["measured_verdict"] == a["verdict"]),
            "timed_out": sum(
                1 for r in self.finished.values() if r.timed_out),
            "cancelled": sum(
                1 for r in self.finished.values() if r.cancelled),
            "degraded": self.degraded,
            "machine_pack": self._machine_pack_label(),
            "repriced_admissions": sum(
                1 for a in self.admission_log if a.get("repriced")),
            "health": self.health.rollup(),
        }
