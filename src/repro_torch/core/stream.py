"""Streams and tokens (paper Definition 1 + the §4 BSPlib streaming primitives).

A *stream* is an ordered, finite collection of tokens, each of which fits in the
local memory of a core. Contrary to classic streaming, BSPS streams are
*pseudo*-streams: a cursor supports relative :meth:`Stream.seek` (the paper's
``bsp_stream_seek`` / ``MOVE``), tokens may be revisited or skipped, and streams
are mutable (``move_up`` writes back).

This module is the host-side realisation: tokens are numpy (or torch) views of
a backing array resident in "external memory" — host RAM, staged to the card by
:mod:`repro_torch.core.hyperstep`. The CUDA kernels realise the same concept
one level down, streaming tiles from device memory into shared memory.

Exclusivity (paper §4: "Streams can only be opened if they are not yet opened by
another core") is enforced by the ``owner`` handle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np
import torch

__all__ = ["Stream", "StreamSet", "StreamOwnership", "StreamClosedError",
           "StreamBusyError"]


class StreamClosedError(RuntimeError):
    pass


class StreamBusyError(RuntimeError):
    pass


class StreamOwnership:
    """The paper-§4 exclusivity handle: open/close with a single owner core.

    "Streams can only be opened if they are not yet opened by another core."
    Shared by :class:`Stream` and the duck-typed stream adapters
    so the state machine exists exactly once. Subclasses provide ``token_size`` (returned by
    ``open``, the §4 contract) and may override :meth:`_rewind`, called when
    the stream is closed.
    """

    _owner: int | None = None

    def _stream_label(self) -> str:
        name = getattr(self, "name", "")
        return name or f"stream {getattr(self, 'stream_id', '?')}"

    def open(self, core: int) -> int:
        """``bsp_stream_open`` — returns max token size in *elements*."""
        if self._owner is not None and self._owner != core:
            raise StreamBusyError(
                f"{self._stream_label()} already opened by core {self._owner}")
        self._owner = core
        return self.token_size

    def close(self, core: int) -> None:
        """``bsp_stream_close`` — after closing any core can open it again."""
        self._check_owner(core)
        self._owner = None
        self._rewind()

    def _rewind(self) -> None:
        """Cursor reset on close; adapters override as appropriate."""

    def _check_owner(self, core: int) -> None:
        if self._owner is None:
            raise StreamClosedError(f"{self._stream_label()} is not open")
        if self._owner != core:
            raise StreamBusyError(
                f"{self._stream_label()} owned by core {self._owner}, not {core}")


@dataclasses.dataclass
class Stream(StreamOwnership):
    """A mutable pseudo-stream over a backing 1-D (or leading-axis) array.

    ``data``        backing array, tokens are equal slices along axis 0
                    (paper: "tokens of the i-th stream have constant size C_i").
    ``token_size``  C_i — elements per token along axis 0.
    ``stream_id``   creation-order id (paper §4).

    ``open``/``close`` (and their exclusivity) come from
    :class:`StreamOwnership`; closing rewinds the cursor.
    """

    data: Any
    token_size: int
    stream_id: int = 0
    name: str = ""

    _cursor: int = dataclasses.field(default=0, init=False)
    _owner: int | None = dataclasses.field(default=None, init=False)

    def __post_init__(self) -> None:
        if self.token_size <= 0:
            raise ValueError("token_size must be positive")
        if self.data.shape[0] % self.token_size != 0:
            raise ValueError(
                f"[BSPS103] stream length {self.data.shape[0]} not divisible "
                f"by token size {self.token_size}; the tail would silently "
                f"truncate — pad the backing array"
            )

    # -- BSPlib-extension primitives (paper §4) ------------------------------

    def _rewind(self) -> None:
        self._cursor = 0

    def move_down(self, core: int, preload: bool = True) -> Any:
        """``bsp_stream_move_down`` — read token at cursor, advance cursor.

        ``preload`` is semantic only at this level (prefetch is modelled in the
        cost function and realised in :mod:`repro_torch.core.hyperstep`).
        """
        self._check_owner(core)
        if not 0 <= self._cursor < self.num_tokens:
            raise IndexError(
                f"stream {self.stream_id}: cursor {self._cursor} out of range "
                f"[0, {self.num_tokens})"
            )
        tok = self.peek(self._cursor)
        self._cursor += 1
        return tok

    def move_up(self, core: int, token: Any) -> int:
        """``bsp_stream_move_up`` — write token at cursor, advance cursor.

        Returns the number of words written (C_i), so the runtime can account
        write-back traffic per hyperstep. ``None`` tokens are a no-op seek —
        the cursor advances but nothing moves on the link (0 words) — which
        lets sparse up-streams (e.g. a checkpoint every k steps) share the
        one-``move_up``-per-hyperstep schedule.
        """
        self._check_owner(core)
        if not 0 <= self._cursor < self.num_tokens:
            raise IndexError(
                f"stream {self.stream_id}: cursor {self._cursor} out of range "
                f"[0, {self.num_tokens})"
            )
        if token is None:
            self._cursor += 1
            return 0
        lo = self._cursor * self.token_size
        hi = lo + self.token_size
        if isinstance(self.data, np.ndarray):
            if isinstance(token, torch.Tensor):
                token = token.cpu().numpy()
            self.data[lo:hi] = np.asarray(token).reshape(self.data[lo:hi].shape)
        else:  # a torch backing is written in place
            self.data[lo:hi] = torch.as_tensor(token).to(
                self.data.device, self.data.dtype).reshape(self.data[lo:hi].shape)
        self._cursor += 1
        return self.token_words

    def seek(self, core: int, delta_tokens: int) -> None:
        """``bsp_stream_seek`` — move cursor *relative* (random access)."""
        self._check_owner(core)
        new = self._cursor + delta_tokens
        if not 0 <= new <= self.num_tokens:
            raise IndexError(f"seek to {new} outside [0, {self.num_tokens}]")
        self._cursor = new

    # -- compiled-mode views (device-resident stacked tokens) ----------------

    def as_stacked(self, device: Any = "cpu") -> torch.Tensor:
        """Device-resident copy of the whole stream, one token per row.

        Shape ``(num_tokens,) + token_shape`` on ``device``;
        ``as_stacked()[i]`` equals the token :meth:`move_down` returns at
        cursor ``i``. This is the external-memory image a compiled hyperstep
        program (:meth:`repro_torch.core.hyperstep.HyperstepRunner.compile`)
        gathers from with static index arrays — the whole pseudo-stream
        staged once, the cursor walk replayed on the device with no host
        sync per hyperstep. The copy is a snapshot: re-stage after mutating
        ``data``.
        """
        shape = (self.num_tokens, self.token_size) + tuple(self.data.shape[1:])
        host = torch.as_tensor(self.data).reshape(shape)
        device = torch.device(device)
        if device.type == "cuda" and host.device.type == "cpu":
            host = host.pin_memory()
        return host.to(device, non_blocking=True, copy=True)

    def load_stacked(self, stacked: torch.Tensor) -> None:
        """Write a compiled run's output buffer back into the backing array.

        Inverse of :meth:`as_stacked`: ``stacked`` is ``(num_tokens,) +
        token_shape`` and overwrites the backing in place, keeping its array
        kind (numpy backings stay numpy so host consumers see plain arrays).
        """
        flat_shape = self.data.shape
        if isinstance(self.data, np.ndarray):
            self.data[...] = stacked.cpu().numpy().reshape(flat_shape)
        else:
            self.data.copy_(stacked.reshape(flat_shape))

    # -- inspection ----------------------------------------------------------

    def peek(self, index: int) -> Any:
        """Random access without cursor motion (tokens may be reused freely)."""
        lo = index * self.token_size
        return self.data[lo : lo + self.token_size]

    @property
    def cursor(self) -> int:
        return self._cursor

    @property
    def num_tokens(self) -> int:
        return self.data.shape[0] // self.token_size

    @property
    def token_shape(self) -> tuple[int, ...]:
        """Shape of one token: (token_size,) + trailing dims of the backing."""
        return (self.token_size,) + tuple(self.data.shape[1:])

    @property
    def dtype(self) -> Any:
        return self.data.dtype

    @property
    def token_words(self) -> int:
        """Words per token (C_i in the cost function): elements × trailing dims."""
        trailing = int(np.prod(self.data.shape[1:], dtype=np.int64)) if self.data.ndim > 1 else 1
        return self.token_size * trailing

    @property
    def exhausted(self) -> bool:
        return self._cursor >= self.num_tokens

    def __iter__(self) -> Iterator[Any]:
        for i in range(self.num_tokens):
            yield self.peek(i)


class StreamSet:
    """Host-side registry: creation-order ids, one per ``bsp_stream_create``."""

    def __init__(self) -> None:
        self._streams: list[Stream] = []

    def create(self, data: Any, token_size: int, name: str = "") -> Stream:
        s = Stream(data=data, token_size=token_size,
                   stream_id=len(self._streams), name=name)
        self._streams.append(s)
        return s

    def create_cyclic(self, vector: Any, p: int, token_size: int,
                      name: str = "") -> list[Stream]:
        """Cyclic distribution of a vector into p per-core streams (paper §3.1).

        Component i goes to core ``i mod p``; each core's components are then cut
        into tokens of ``token_size`` elements (padding with zeros). A numpy
        vector gives numpy backings (host external memory, staged to the card
        by the runner); a ``torch.Tensor`` gives tensors on its device.
        """
        n = vector.shape[0]
        per_core = math.ceil(n / p)
        per_core = math.ceil(per_core / token_size) * token_size
        tail = tuple(vector.shape[1:])
        streams = []
        for s in range(p):
            if isinstance(vector, torch.Tensor):
                chunk = vector.new_zeros((per_core,) + tail)
                part = vector[s::p]
            else:
                chunk = np.zeros((per_core,) + tail, dtype=vector.dtype)
                part = np.asarray(vector)[s::p]
            chunk[: part.shape[0]] = part
            streams.append(self.create(chunk, token_size, name=f"{name}[{s}]"))
        return streams

    def create_block_grid(self, matrix: Any, m_blocks: int, n_grid: int = 1,
                          *, order: str = "row", name: str = "") -> list[Stream]:
        """Outer-block streams of a square matrix for an N×N core grid (§3.2).

        Cuts ``matrix`` into M×M outer blocks of side K = n/M, each of which
        is block-distributed over the N×N core grid in k×k sub-blocks
        (k = K/N). The stream for core (ci, cj) holds that core's sub-block
        of every outer block, outer blocks ordered row-major (``"row"``, the
        paper's Σ^A layout) or column-major (``"col"``, Σ^B). Returns the
        p = N² streams in row-major core order — one per core, each with
        M² one-sub-block tokens, ready for a multi-core
        :class:`~repro_torch.core.hyperstep.HyperstepRunner`. The backing
        follows the input: numpy in, numpy out; a tensor gives tensors on
        its device, in pinned memory when the tensor is pinned (so the
        runner's lanes copy its tokens to the card without staging them).
        """
        if order not in ("row", "col"):
            raise ValueError(f"order must be 'row' or 'col', got {order!r}")
        n = matrix.shape[0]
        if matrix.ndim != 2 or matrix.shape[1] != n:
            raise ValueError(f"need a square matrix, got {tuple(matrix.shape)}")
        if n % (m_blocks * n_grid) != 0:
            raise ValueError(
                f"n={n} must be divisible by M·N={m_blocks * n_grid} "
                "(paper pads with zeros)")
        big = n // m_blocks            # outer block side K
        k = big // n_grid              # per-core sub-block side
        coords = [(r, c) for r in range(m_blocks) for c in range(m_blocks)]
        if order == "col":
            coords = [(r, c) for c in range(m_blocks) for r in range(m_blocks)]
        is_tensor = isinstance(matrix, torch.Tensor)
        mat = matrix if is_tensor else np.asarray(matrix)
        stack = torch.stack if is_tensor else np.stack
        streams = []
        for ci in range(n_grid):
            for cj in range(n_grid):
                toks = stack([
                    mat[r * big + ci * k: r * big + (ci + 1) * k,
                        c * big + cj * k: c * big + (cj + 1) * k]
                    for r, c in coords])
                if is_tensor and matrix.is_pinned():
                    toks = toks.pin_memory()
                streams.append(
                    self.create(toks, 1, name=f"{name}[{ci},{cj}]"))
        return streams

    def create_lanes(self, num_tokens: int, lanes: int, *,
                     dtype: Any = np.int32, name: str = "lane") -> list[Stream]:
        """One independent up-stream per lane of a packed batch.

        Each lane of a continuous-batching engine owns its own write-back
        stream of ``num_tokens`` scalar tokens (the generated ids of one
        request segment) — retiring a request hands its lane's stream to the
        next admitted request without touching the other lanes' streams.
        """
        if num_tokens <= 0 or lanes <= 0:
            raise ValueError(
                f"need num_tokens > 0 and lanes > 0, got {num_tokens}, {lanes}")
        return [self.create(np.zeros((num_tokens,), dtype), 1,
                            name=f"{name}[{i}]")
                for i in range(lanes)]

    def stacked(self, device: Any = "cpu") -> list[torch.Tensor]:
        """Device-resident stacked copies of every stream (creation order).

        One :meth:`Stream.as_stacked` per stream — the external-memory image a
        compiled hyperstep program gathers from.
        """
        return [s.as_stacked(device) for s in self._streams]

    def __getitem__(self, stream_id: int) -> Stream:
        return self._streams[stream_id]

    def __len__(self) -> int:
        return len(self._streams)

    def all(self) -> Sequence[Stream]:
        return tuple(self._streams)
