"""Shared-memory data plane for the page transport.

Large chunk transfers never ride the socket: the responder writes the
missing chunks' raw bytes into a ``multiprocessing.shared_memory``
segment and the wire carries only ``(page_index, shm_offset, length)``
descriptors.  The requester maps the segment and scatters straight into
its :class:`~repro_torch.core.arena.InstanceArena` via the existing
``install_block`` fast path — one copy total (segment -> arena), no
intermediate socket buffer.

Segment lifetime contract (the wire enforces it):

  * the **responder** creates + writes the segment and keeps it alive
    until the requester's RELEASE frame (or the connection dying, which
    counts as an implicit release);
  * the **requester** attaches, verifies chunk hashes against the
    manifest, installs/copies, closes its mapping, then releases;
  * the responder ``close()`` + ``unlink()``s — exactly one unlink per
    segment, so a crashed requester can never leak ``/dev/shm`` entries
    past its connection.

Chunks below the inline threshold (or hosts without shm support) fall
back to inline-on-socket payloads; wire.py makes that call.
"""
from __future__ import annotations

import numpy as np

try:
    from multiprocessing import shared_memory as _shm
except ImportError:                   # pragma: no cover - platform detail
    _shm = None

from ..core.arena import PAGE

_AVAILABLE: bool | None = None


def shm_available() -> bool:
    """True when a shared-memory segment can actually be created here
    (import succeeding is not enough: /dev/shm may be absent or sealed).
    Probed once per process."""
    global _AVAILABLE
    if _AVAILABLE is None:
        if _shm is None:
            _AVAILABLE = False
        else:
            try:
                seg = _shm.SharedMemory(create=True, size=PAGE)
                seg.close()
                seg.unlink()
                _AVAILABLE = True
            except (OSError, ValueError):
                _AVAILABLE = False
    return _AVAILABLE


class ShmSegment:
    """Responder-side segment: chunk payloads written back to back.

    ``write_chunks`` returns per-chunk offsets; the wire ships those as
    descriptors.  The segment stays alive until :meth:`release`.
    """

    def __init__(self, n_bytes: int):
        if _shm is None:
            raise OSError("multiprocessing.shared_memory unavailable")
        self.seg = _shm.SharedMemory(create=True, size=max(n_bytes, 1))
        self.name = self.seg.name
        self.size = self.seg.size
        self._off = 0

    def write_chunk(self, block: bytes) -> int:
        """Append one chunk; returns its segment offset."""
        off = self._off
        end = off + len(block)
        if end > self.size:
            raise ValueError(f"shm segment overflow ({end} > {self.size})")
        self.seg.buf[off:end] = block
        self._off = end
        return off

    def release(self) -> None:
        """Close and unlink (responder side, exactly once)."""
        try:
            self.seg.close()
            self.seg.unlink()
        except (OSError, FileNotFoundError):
            pass                      # already gone: release is idempotent


class ShmView:
    """Requester-side mapping of a responder's segment.

    ``block(off, n_chunks)`` exposes ``n_chunks`` contiguous chunks as a
    zero-copy ``(n_chunks, PAGE)`` uint8 view suitable for
    ``InstanceArena.install_block`` — the scatter reads the mapped
    segment directly.  Close the view only after the install."""

    def __init__(self, name: str):
        if _shm is None:
            raise OSError("multiprocessing.shared_memory unavailable")
        self.seg = _shm.SharedMemory(name=name)

    def chunk(self, off: int, length: int) -> memoryview:
        return self.seg.buf[off:off + length]

    def block(self, off: int, n_chunks: int) -> np.ndarray:
        return np.frombuffer(self.seg.buf, dtype=np.uint8,
                             count=n_chunks * PAGE,
                             offset=off).reshape(-1, PAGE)

    def close(self) -> None:
        try:
            self.seg.close()          # never unlink: the responder owns it
        except (OSError, BufferError):
            pass
