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
