"""Token data pipeline as a BSPS stream (DESIGN.md level 2).

The JAX package's ``data/pipeline.py``, with the same batches: each is made
in numpy exactly as the reference makes it, so one ``DataConfig`` gives
both packages equal batches element for element.

The training corpus is a stream of *batch tokens*; each training step is a
hyperstep: step t's compute overlaps the prefetch of batch t+1 (the DMA lane
of :class:`repro_torch.core.hyperstep.HyperstepRunner`). The pipeline cursor
is exactly a stream cursor: checkpoint/restart is ``seek`` (the paper's §4
primitive), so resume is bit-identical.

Sources: ``synthetic`` (seeded, reproducible) or a binary uint32 token file
(``np.memmap``). Sharding across hosts is by cursor stride (host h of H
reads batches h, h+H, …), which keeps restart arithmetic trivial.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.stream import StreamOwnership
from repro_torch.core.trace import traced

__all__ = ["DataConfig", "DataSourceError", "TokenStream", "BatchStream",
           "Prefetcher"]


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    source: str = "synthetic"      # synthetic | <path to uint32 token file>
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    # bounded retry-with-backoff on source reads (DESIGN.md §10): a read of
    # batch i gets read_retries retries, sleeping backoff * 2^attempt between
    read_retries: int = 2
    retry_backoff_s: float = 0.01


class DataSourceError(RuntimeError):
    """A data-source read failed past its retry budget.

    Carries the failing batch (shard) index, so the consumer knows exactly
    which read to investigate or re-drive — this is what a prefetch thread
    surfaces instead of dying silently.
    """

    def __init__(self, batch_index: int, cause: BaseException | None = None):
        msg = f"data source failed at batch index {batch_index}"
        if cause is not None:
            msg += f": {cause!r}"
        super().__init__(msg)
        self.batch_index = int(batch_index)
        self.cause = cause


class TokenStream:
    """Stateful, seekable batch stream. State = one integer cursor.

    ``faults`` is an optional :class:`~repro_torch.core.faults.FaultInjector`
    whose ``data_error`` triggers fire on batch reads; ``health`` an optional
    :class:`~repro_torch.core.health.HealthMonitor` that receives BSPS210
    (read retried) / BSPS211 (retries exhausted) events. Every read goes
    through the bounded retry of :meth:`_read_with_retry`.
    """

    def __init__(self, cfg: DataConfig, *, faults: Any | None = None,
                 health: Any | None = None):
        self.cfg = cfg
        self.faults = faults
        self.health = health
        self.retry_log: list[tuple[int, int]] = []   # (batch index, attempt)
        self._cursor = cfg.host_index
        self._producer: _PrefetchProducer | None = None
        self._data: np.memmap | None = None
        if cfg.source != "synthetic":
            self._data = np.memmap(cfg.source, dtype=np.uint32, mode="r")
            n_tok = self._data.shape[0]
            self._batches = n_tok // (cfg.seq_len + 1) // cfg.global_batch
            if self._batches == 0:
                raise ValueError(f"{cfg.source}: too small for one batch")

    # -- stream primitives (paper §4) -------------------------------------

    @property
    def cursor(self) -> int:
        return self._cursor

    def seek(self, cursor: int) -> None:
        self._cursor = int(cursor)
        if self._producer is not None:
            # the lookahead was built from the old cursor: flush + restart
            depth = self._producer.depth
            self.stop_prefetch()
            self.start_prefetch(depth)

    def state_dict(self) -> dict[str, Any]:
        return {"cursor": self._cursor, "seed": self.cfg.seed}

    def state_at(self, n_batches: int) -> dict[str, Any]:
        """State after exactly ``n_batches`` consumed batches.

        Unlike :meth:`state_dict` this is immune to prefetch lookahead: a
        checkpoint written after step t must record the cursor of batch t+1,
        not wherever the background fetch has run ahead to — the BSPS restart
        is a ``seek`` to a hyperstep boundary.
        """
        return {"cursor": self.cfg.host_index + n_batches * self.cfg.host_count,
                "seed": self.cfg.seed}

    def load_state_dict(self, state: dict[str, Any]) -> None:
        self.seek(int(state["cursor"]))

    def next_batch(self) -> dict[str, np.ndarray]:
        if self._producer is not None:
            index, item = self._producer.q.get()
            if isinstance(item, BaseException):
                raise item
            self._cursor = index + self.cfg.host_count
            return item
        batch = self._read_with_retry(self._cursor)
        self._cursor += self.cfg.host_count
        return batch

    def _read_with_retry(self, index: int) -> dict[str, np.ndarray]:
        """One guarded batch read: ``read_retries`` retries with backoff.

        Injected ``data_error`` faults and real source errors retry alike;
        exhaustion raises :class:`DataSourceError` carrying the failing batch
        index. Each retry is logged (``retry_log``) and reported to the
        health monitor (BSPS210; BSPS211 on exhaustion) when one is attached.
        """
        c = self.cfg
        last: BaseException | None = None
        for attempt in range(c.read_retries + 1):
            try:
                if self.faults is not None:
                    self.faults.data_error(index)
                return self._make(index)
            except Exception as e:          # noqa: BLE001 — retried, then surfaced
                last = e
                self.retry_log.append((index, attempt))
                if self.health is not None:
                    self.health.emit(
                        "BSPS210", f"data read failed at batch {index} "
                        f"(attempt {attempt + 1}): {e}", index=index)
                if attempt < c.read_retries:
                    time.sleep(c.retry_backoff_s * (2 ** attempt))
        if self.health is not None:
            self.health.emit(
                "BSPS211", f"data read retries exhausted at batch {index}",
                index=index)
        raise DataSourceError(index, last)

    # -- prefetch deepening (the BSPS202 response) --------------------------

    def start_prefetch(self, depth: int = 4) -> None:
        """Run reads ``depth`` batches ahead on a background producer.

        The runtime response to fetch-wait-dominant hypersteps (BSPS202):
        deepening the fetch pipeline re-tunes the effective block size
        without touching the consumer protocol — :meth:`next_batch` still
        returns batches in cursor order, and a failed read surfaces as
        :class:`DataSourceError` on the consumer side, never a hang.
        """
        if self._producer is None:
            self._producer = _PrefetchProducer(self, max(1, int(depth)))

    def stop_prefetch(self) -> None:
        if self._producer is not None:
            self._producer.close()
            self._producer = None

    @property
    def prefetch_depth(self) -> int:
        return 0 if self._producer is None else self._producer.depth

    def _make(self, index: int) -> dict[str, np.ndarray]:
        c = self.cfg
        if self._data is None:
            rng = np.random.default_rng(np.random.SeedSequence([c.seed, index]))
            toks = rng.integers(0, c.vocab_size, (c.global_batch, c.seq_len + 1),
                                dtype=np.int64).astype(np.int32)
        else:
            i = index % self._batches
            span = c.global_batch * (c.seq_len + 1)
            flat = np.asarray(self._data[i * span : (i + 1) * span], dtype=np.int64)
            toks = (flat % c.vocab_size).astype(np.int32).reshape(
                c.global_batch, c.seq_len + 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


class _PrefetchProducer:
    """The background half of :meth:`TokenStream.start_prefetch`.

    Items on the queue are ``(batch index, batch-or-exception)`` — an
    exception item is the *last* item the producer enqueues, so the consumer
    raises it from ``next_batch`` instead of blocking on an empty queue
    behind a dead thread.
    """

    def __init__(self, stream: TokenStream, depth: int):
        self.depth = depth
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stream = stream
        self._next = stream.cursor
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bsps-data-prefetch")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            index = self._next
            try:
                item: Any = self._stream._read_with_retry(index)
            except BaseException as e:      # noqa: BLE001 — surfaced to consumer
                item = e
            self._next += self._stream.cfg.host_count
            while not self._stop.is_set():
                try:
                    self.q.put((index, item), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


class BatchStream(StreamOwnership):
    """:class:`TokenStream` as a paper-§4 down-stream: one batch per token.

    Speaks the :class:`repro_torch.core.stream.Stream` protocol (open /
    move_down / close / seek, exclusivity, cursor) without a materialised
    backing array — tokens are generated on demand, so ``external memory``
    here is the corpus itself. This is what lets the training loop run
    through :class:`repro_torch.core.hyperstep.HyperstepRunner` and be priced
    by :func:`repro_torch.core.plan.host_plan` like any other stream program.

    ``num_tokens`` bounds the run (the planned hyperstep count); the wrapped
    TokenStream's cursor — not ours — is the durable data position, so
    ``close()`` rewinds only the local hyperstep counter.
    """

    token_size = 1  # one batch per token

    def __init__(self, stream: TokenStream, num_tokens: int, *,
                 put_fn=None, name: str = "batches", stream_id: int = 0):
        self._stream = stream
        self._num = int(num_tokens)
        self._put = put_fn or (lambda x: x)
        self._cursor = 0
        self._owner: int | None = None
        self.name = name
        self.stream_id = stream_id

    # -- stream protocol (open/close/exclusivity from StreamOwnership) -------

    def _rewind(self) -> None:
        self._cursor = 0

    @traced("repro_torch.data.fetch")
    def move_down(self, core: int) -> dict[str, Any]:
        self._check_owner(core)
        if not 0 <= self._cursor < self._num:
            raise IndexError(
                f"batch stream: cursor {self._cursor} out of range [0, {self._num})")
        self._cursor += 1
        return self._put(self._stream.next_batch())

    def seek(self, core: int, delta_tokens: int) -> None:
        self._check_owner(core)
        new = self._cursor + delta_tokens
        if not 0 <= new <= self._num:
            raise IndexError(f"seek to {new} outside [0, {self._num}]")
        self._cursor = new
        self._stream.seek(self._stream.cursor
                          + delta_tokens * self._stream.cfg.host_count)

    def as_stacked(self, device: Any = "cpu") -> dict[str, torch.Tensor]:
        """The whole batch window as one stacked dict on ``device``
        (compiled-mode view).

        ``as_stacked()[k][i]`` equals the *raw* batch ``move_down`` would
        return at local cursor i: batches are generated from the wrapped
        :class:`TokenStream` without moving its durable cursor — consumption
        happens when the compiled run seeks this stream past the tokens it
        gathered, exactly like the host loop's ``move_down`` calls. On the
        card each stacked leaf crosses through pinned host memory, as
        :meth:`repro_torch.core.stream.Stream.as_stacked` stages.

        ``put_fn`` is *not* applied: it exists for per-batch placement,
        which the compiled run does itself. A put_fn that transforms batch
        *values* needs the host loop.
        """
        hc = self._stream.cfg.host_count
        base = self._stream.cursor - self._cursor * hc
        batches = [self._stream._read_with_retry(base + i * hc)
                   for i in range(self._num)]
        device = torch.device(device)
        out = {}
        for k in batches[0]:
            host = torch.from_numpy(np.stack([np.asarray(b[k]) for b in batches]))
            if device.type == "cuda":
                host = host.pin_memory()
            out[k] = host.to(device, non_blocking=True)
        return out

    # -- plan protocol (host_plan pricing) -----------------------------------

    @property
    def cursor(self) -> int:
        return self._cursor

    @property
    def num_tokens(self) -> int:
        return self._num

    @property
    def token_shape(self) -> tuple[int, ...]:
        c = self._stream.cfg
        return (1, c.global_batch, c.seq_len + 1)

    @property
    def dtype(self):
        return np.int32

    @property
    def token_words(self) -> int:
        c = self._stream.cfg
        return c.global_batch * (c.seq_len + 1)


class Prefetcher:
    """Depth-N background prefetch: the hyperstep's concurrent token fetch.

    Depth ≥ 2 means one slow fetch does not stall the step (straggler
    mitigation at the input layer — the paper's double-buffering argument).
    The training loop itself overlaps through
    :class:`repro_torch.core.hyperstep.HyperstepRunner` + :class:`BatchStream`;
    this class remains for ad-hoc pipelines that want a deeper queue.
    """

    def __init__(self, stream: TokenStream, depth: int = 2,
                 put_fn=None):
        self._stream = stream
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._put = put_fn or (lambda x: x)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bsps-data-dma")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            index = self._stream.cursor
            try:
                batch: Any = self._put(self._stream.next_batch())
            except BaseException as e:      # noqa: BLE001 — surfaced to consumer
                # surface the failure (with its shard index) on the consumer
                # side rather than dying silently and hanging get() forever
                if not isinstance(e, DataSourceError):
                    e = DataSourceError(index, e)
                while not self._stop.is_set():
                    try:
                        self._q.put(e, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                return
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def get(self) -> dict[str, Any]:
        item = self._q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
