"""Framed chunk protocol over Unix-domain sockets.

One frame is ``MAGIC(4) | type(1) | length(4, big-endian) | payload``.
The conversation mirrors the shard tier's dedup accounting, but over a
real wire:

  requester                         responder
  ---------                         ---------
  FETCH base + digest(have) ---->
                             <----  MANIFEST {pages, hashes, chunks...}
                             <----  CHUNKS <blob>          (inline mode)
  RELEASE ------------------>                              (shm mode)

The requester sends the 16-byte digests of every chunk it already holds
in its L1 index; the responder ships only the unique missing chunks.
Transport is chosen per response: payloads above ``inline_max_bytes``
ride a shared-memory segment (wire carries only ``(hash, off, len)``
descriptors; see :mod:`~repro_torch.transport.shm` for the lifetime
contract), smaller ones are framed inline with optional per-chunk
compression (:mod:`~repro_torch.transport.codec`).  A cold pull with an empty
have-set gets ``layout: full`` — the responder memcpys the whole WS
blob into the segment in page order so the requester can verify and
``install_block`` straight out of the mapping with zero intermediate
copy.

Every received chunk is re-hashed against the manifest before it is
surfaced; a corrupt payload raises :class:`ChunkHashMismatchError` and
nothing is installed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import struct
import threading
import time

import numpy as np

from ..core.arena import PAGE
from ..core.pagestore import chunk_hash
from .codec import CodecStats, decode_chunk, encode_chunk
from .shm import ShmSegment, ShmView, shm_available

MAGIC = b"RPT1"
HEADER = struct.Struct(">4sBI")       # magic, frame type, payload length
MAX_FRAME = 1 << 28                   # 256 MiB: a frame larger than any WS

T_FETCH = 1
T_MANIFEST = 2
T_CHUNKS = 3
T_RELEASE = 4
T_OK = 5
T_ERR = 6

DIGEST_BYTES = 16                     # blake2b-128, matches pagestore.chunk_hash
FETCH_TIMEOUT_S = 120.0               # PageClient's bound on one socket operation


class WireError(Exception):
    """Base for transport protocol failures."""


class TruncatedFrameError(WireError):
    """Peer closed (or corrupted) mid-frame."""


class BadMagicError(WireError):
    """Frame header does not start with ``RPT1``."""


class ChunkHashMismatchError(WireError):
    """A received chunk does not hash to its manifest entry."""


# ---------------------------------------------------------------- framing

def _recv_exact(conn: socket.socket, n: int, *, what: str = "frame") -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            got = conn.recv(n - len(buf))
        except OSError as e:
            raise TruncatedFrameError(f"recv failed mid-{what}: {e}") from e
        if not got:
            raise TruncatedFrameError(
                f"peer closed mid-{what} ({len(buf)}/{n} bytes)")
        buf += got
    return bytes(buf)


def send_frame(conn: socket.socket, ftype: int, payload: bytes = b"") -> int:
    """Send one frame; returns bytes put on the wire."""
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame payload {len(payload)} exceeds MAX_FRAME")
    head = HEADER.pack(MAGIC, ftype, len(payload))
    conn.sendall(head + payload)
    return HEADER.size + len(payload)


def recv_frame(conn: socket.socket, *,
               allow_eof: bool = False) -> tuple[int, bytes] | None:
    """Receive one frame as ``(type, payload)``.

    ``allow_eof=True`` returns None on a clean close at a frame
    boundary (zero bytes before any header byte); EOF anywhere else is
    always a :class:`TruncatedFrameError`.
    """
    try:
        first = conn.recv(1)
    except OSError as e:
        raise TruncatedFrameError(f"recv failed at frame start: {e}") from e
    if not first:
        if allow_eof:
            return None
        raise TruncatedFrameError("peer closed at frame start")
    head = first + _recv_exact(conn, HEADER.size - 1, what="header")
    magic, ftype, length = HEADER.unpack(head)
    if magic != MAGIC:
        raise BadMagicError(f"bad frame magic {magic!r}")
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    return ftype, _recv_exact(conn, length, what="payload")


def pack_fetch(base: str, have) -> bytes:
    """FETCH payload: base name + the requester's L1 chunk-index digest
    (the 16-byte binary form of each held chunk hash)."""
    b = base.encode("utf-8")
    digests = b"".join(bytes.fromhex(h) for h in have)
    return struct.pack(">H", len(b)) + b + digests


def unpack_fetch(payload: bytes) -> tuple[str, set[str]]:
    (blen,) = struct.unpack_from(">H", payload)
    base = payload[2:2 + blen].decode("utf-8")
    raw = payload[2 + blen:]
    if len(raw) % DIGEST_BYTES:
        raise WireError("fetch digest list not a multiple of 16 bytes")
    have = {raw[i:i + DIGEST_BYTES].hex()
            for i in range(0, len(raw), DIGEST_BYTES)}
    return base, have


def percentiles(seconds) -> dict:
    """``count``, ``sum``, ``p50`` and ``p95`` of a list of seconds."""
    r = sorted(seconds)
    if not r:
        return {"count": 0, "sum": 0.0, "p50": 0.0, "p95": 0.0}
    return {"count": len(r), "sum": round(sum(r), 6),
            "p50": round(r[len(r) // 2], 6),
            "p95": round(r[min(len(r) - 1, int(len(r) * 0.95))], 6)}


# ----------------------------------------------------------------- server

@dataclasses.dataclass
class ServerStats:
    """Per-server wire accounting (thread-safe via the handler lock)."""
    requests: int = 0
    misses: int = 0
    chunks_shipped: int = 0
    shm_responses: int = 0
    inline_responses: int = 0
    wire_tx_bytes: int = 0
    wire_rx_bytes: int = 0
    shm_bytes: int = 0

    def __post_init__(self) -> None:
        self._mu = threading.Lock()
        #: seconds from a FETCH's arrival to its MANIFEST's send: the
        #: responder's manifest, segment copy and interpreter waits
        self._preps: list[float] = []

    def prep_percentiles(self) -> dict:
        with self._mu:
            return percentiles(self._preps)

    def as_dict(self) -> dict:
        with self._mu:
            return {k: getattr(self, k) for k in (
                "requests", "misses", "chunks_shipped", "shm_responses",
                "inline_responses", "wire_tx_bytes", "wire_rx_bytes",
                "shm_bytes")}


class PageServer:
    """Serves WS chunks for one node over a Unix-domain socket.

    ``serve(base)`` must return ``(pages, data, hashes)`` — the
    ``peek_chunks`` shape — or None when the WS is not resident.  Each
    connection gets a handler thread; handlers are tracked and joined in
    :meth:`close`.
    """

    def __init__(self, path: str, serve, *, inline_max_bytes: int = 64 << 10,
                 compress: bool = False, use_shm: bool = True,
                 level: int = 1):
        self.path = path
        self.serve = serve
        self.inline_max_bytes = inline_max_bytes
        self.compress = compress
        self.use_shm = use_shm and shm_available()
        self.level = level
        self.stats = ServerStats()
        self.codec = CodecStats()
        self._closed = threading.Event()
        self._conns: set[socket.socket] = set()
        self._threads: list[threading.Thread] = []
        self._mu = threading.Lock()
        if os.path.exists(path):
            os.unlink(path)           # stale endpoint from a dead server
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(path)
        self._sock.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"pageserver:{path}", daemon=True)
        self._accept_thread.start()

    # -- connection plumbing

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return                # listener closed
            with self._mu:
                if self._closed.is_set():
                    conn.close()
                    return
                self._conns.add(conn)
                t = threading.Thread(target=self._handle, args=(conn,),
                                     name="pageserver-conn", daemon=True)
                self._threads.append(t)
            t.start()

    def _handle(self, conn: socket.socket) -> None:
        try:
            while not self._closed.is_set():
                got = recv_frame(conn, allow_eof=True)
                if got is None:
                    return
                ftype, payload = got
                with self.stats._mu:
                    self.stats.wire_rx_bytes += HEADER.size + len(payload)
                if ftype == T_RELEASE:
                    continue          # stray release: nothing held
                if ftype != T_FETCH:
                    send_frame(conn, T_ERR, json.dumps(
                        {"error": f"unexpected frame type {ftype}"}).encode())
                    return
                self._respond(conn, payload)
        except WireError:
            pass                      # peer vanished; nothing to salvage
        finally:
            with self._mu:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    # -- one fetch/response exchange

    def _respond(self, conn: socket.socket, payload: bytes) -> None:
        t0 = time.monotonic()
        base, have = unpack_fetch(payload)
        with self.stats._mu:
            self.stats.requests += 1
        try:
            served = self.serve(base)
        except Exception as e:        # serve hook failed: report, keep conn
            tx = send_frame(conn, T_ERR,
                            json.dumps({"error": str(e)}).encode())
            with self.stats._mu:
                self.stats.wire_tx_bytes += tx
            return
        if served is None:
            tx = send_frame(conn, T_MANIFEST,
                            json.dumps({"status": "miss"}).encode())
            with self.stats._mu:
                self.stats.misses += 1
                self.stats.wire_tx_bytes += tx
            return

        pages, data, hashes = served
        pages = [int(p) for p in np.asarray(pages)]
        hashes = list(hashes)
        missing: list[str] = []       # unique, first-occurrence order
        seen = set(have)
        for h in hashes:
            if h not in seen:
                seen.add(h)
                missing.append(h)
        first_idx = {}
        for i, h in enumerate(hashes):
            first_idx.setdefault(h, i)
        raw_bytes = len(missing) * PAGE
        full = not have and len(missing) == len(hashes)

        manifest: dict = {"status": "ok", "pages": pages, "hashes": hashes}
        seg: ShmSegment | None = None
        blob = b""
        if missing and self.use_shm and raw_bytes > self.inline_max_bytes:
            manifest["transport"] = "shm"
            if full:
                # Cold pull: the WS blob is already the page-ordered
                # chunk sequence — one memcpy, identity descriptors.
                seg = ShmSegment(len(data))
                seg.seg.buf[:len(data)] = data
                manifest["layout"] = "full"
            else:
                seg = ShmSegment(raw_bytes)
                chunks = []
                for h in missing:
                    i = first_idx[h]
                    block = data[i * PAGE:(i + 1) * PAGE]
                    off = seg.write_chunk(block)
                    chunks.append({"h": h, "off": off, "len": PAGE,
                                   "enc": "raw"})
                manifest["layout"] = "sparse"
                manifest["chunks"] = chunks
            manifest["shm"] = {"name": seg.name, "size": seg.size}
            with self.stats._mu:
                self.stats.shm_responses += 1
                self.stats.shm_bytes += raw_bytes
                self.stats.chunks_shipped += len(missing)
        else:
            manifest["transport"] = "inline"
            manifest["layout"] = "sparse"
            chunks = []
            parts = []
            off = 0
            for h in missing:
                i = first_idx[h]
                block = data[i * PAGE:(i + 1) * PAGE]
                enc, packed = encode_chunk(block, compress=self.compress,
                                           level=self.level)
                self.codec.record(enc, len(block), len(packed))
                chunks.append({"h": h, "off": off, "len": len(packed),
                               "enc": enc})
                parts.append(packed)
                off += len(packed)
            manifest["chunks"] = chunks
            blob = b"".join(parts)
            with self.stats._mu:
                self.stats.inline_responses += 1
                self.stats.chunks_shipped += len(missing)

        try:
            body = json.dumps(manifest).encode()
            with self.stats._mu:
                self.stats._preps.append(time.monotonic() - t0)
            tx = send_frame(conn, T_MANIFEST, body)
            if manifest["transport"] == "inline" and missing:
                tx += send_frame(conn, T_CHUNKS, blob)
            with self.stats._mu:
                self.stats.wire_tx_bytes += tx
            if seg is not None:
                # Hold the segment until the requester releases it (a
                # dead connection is an implicit release).
                got = recv_frame(conn, allow_eof=True)
                if got is not None:
                    rtype, rpayload = got
                    with self.stats._mu:
                        self.stats.wire_rx_bytes += HEADER.size + len(rpayload)
                    if rtype != T_RELEASE:
                        raise WireError(
                            f"expected RELEASE after shm manifest, got {rtype}")
        finally:
            if seg is not None:
                seg.release()

    def close(self) -> None:
        self._closed.set()
        # closing a listener does not wake a thread blocked in accept();
        # shutdown + a throwaway self-connect guarantees it returns now
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            wake = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            wake.settimeout(0.5)
            wake.connect(self.path)
            wake.close()
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        with self._mu:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=5.0)
        for t in threads:
            t.join(timeout=5.0)
        if os.path.exists(self.path):
            try:
                os.unlink(self.path)
            except OSError:
                pass


# ----------------------------------------------------------------- client

@dataclasses.dataclass
class FetchResult:
    """One verified fetch: full page list plus the shipped payloads.

    ``chunks`` maps chunk hash -> raw bytes for every chunk the
    responder shipped (already hash-verified); chunks in the have-set
    were not shipped and must come from the requester's own index.
    """
    base: str
    pages: np.ndarray
    hashes: list[str]
    transport: str                    # "shm" | "inline" | "none"
    chunks: dict[str, bytes]
    wire_bytes: int                   # socket bytes both ways, this fetch
    shm_bytes: int
    rtt_s: float

    def assemble(self, lookup=None) -> bytes:
        """Reassemble the full page-ordered WS blob.

        ``lookup(hash) -> bytes`` supplies chunks the responder skipped
        because the requester's digest said it already held them.
        """
        parts = []
        for h in self.hashes:
            blk = self.chunks.get(h)
            if blk is None:
                if lookup is None:
                    raise KeyError(f"chunk {h} not shipped and no lookup")
                blk = lookup(h)
                if blk is None:
                    raise KeyError(f"chunk {h} unavailable locally")
            parts.append(blk)
        return b"".join(parts)


@dataclasses.dataclass
class ClientStats:
    fetches: int = 0
    misses: int = 0
    wire_tx_bytes: int = 0
    wire_rx_bytes: int = 0
    shm_bytes: int = 0
    inline_bytes: int = 0
    dedup_chunks_skipped: int = 0

    def __post_init__(self) -> None:
        self._mu = threading.Lock()
        self._rtts: list[float] = []
        #: seconds from a FETCH's send to its MANIFEST's arrival (the rest
        #: of the RTT is this side's hash checks and copies)
        self._waits: list[float] = []

    def record_rtt(self, s: float) -> None:
        with self._mu:
            self._rtts.append(s)

    def rtt_percentiles(self) -> dict:
        with self._mu:
            return percentiles(self._rtts)

    def as_dict(self) -> dict:
        with self._mu:
            out = {k: getattr(self, k) for k in (
                "fetches", "misses", "wire_tx_bytes", "wire_rx_bytes",
                "shm_bytes", "inline_bytes", "dedup_chunks_skipped")}
        out["fetch_rtt_s"] = self.rtt_percentiles()
        return out


class PageClient:
    """Requester end: one persistent connection to a node's PageServer.

    ``timeout_s`` bounds each socket operation.  A dead peer shows at once
    as a refused or closed connection, so the bound only stops a live one
    that does not answer; it is sized for a full-width WS, whose responder
    builds a manifest of every page and copies the whole WS into shared
    memory before its first byte, while its own invocations compete for
    the interpreter."""

    def __init__(self, path: str, *, timeout_s: float = FETCH_TIMEOUT_S):
        self.path = path
        self.stats = ClientStats()
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.settimeout(timeout_s)
        self._sock.connect(path)
        self._mu = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    # -- core exchange

    def fetch(self, base: str, have=()) -> FetchResult | None:
        """Negotiate + pull ``base``'s WS; None when the peer lacks it.

        Every shipped chunk is re-hashed before the result is returned;
        a mismatch raises :class:`ChunkHashMismatchError` and the fetch
        yields nothing.
        """
        with self._mu:
            return self._fetch_locked(base, have, install=None)

    def fetch_install(self, base: str, arena) -> FetchResult | None:
        """Cold pull with zero-copy install.

        Sends an empty have-set so the responder ships the full WS; on
        the shm path the (n, PAGE) view over the mapped segment is
        handed straight to ``arena.install_block`` — the scatter reads
        shared memory, no intermediate copy.  Chunks are verified from
        the mapping *before* the install.
        """
        with self._mu:
            return self._fetch_locked(base, (), install=arena)

    def _fetch_locked(self, base: str, have, install) -> FetchResult | None:
        t0 = time.monotonic()
        tx = send_frame(self._sock, T_FETCH, pack_fetch(base, have))
        got = recv_frame(self._sock)
        with self.stats._mu:
            self.stats._waits.append(time.monotonic() - t0)
        ftype, payload = got
        rx = HEADER.size + len(payload)
        if ftype == T_ERR:
            raise WireError(json.loads(payload).get("error", "remote error"))
        if ftype != T_MANIFEST:
            raise WireError(f"expected MANIFEST, got frame type {ftype}")
        manifest = json.loads(payload)
        if manifest.get("status") != "ok":
            with self.stats._mu:
                self.stats.fetches += 1
                self.stats.misses += 1
                self.stats.wire_tx_bytes += tx
                self.stats.wire_rx_bytes += rx
            self.stats.record_rtt(time.monotonic() - t0)
            return None

        pages = np.asarray(manifest["pages"], dtype=np.int64)
        hashes: list[str] = manifest["hashes"]
        transport = manifest.get("transport", "none")
        chunks: dict[str, bytes] = {}
        shm_bytes = 0

        if transport == "shm":
            view = ShmView(manifest["shm"]["name"])
            try:
                if manifest.get("layout") == "full":
                    n = len(hashes)
                    block = view.block(0, n)
                    try:
                        for i, h in enumerate(hashes):
                            if chunk_hash(block[i].tobytes()) != h:
                                raise ChunkHashMismatchError(
                                    f"chunk {i} of {base} corrupt in shm")
                        shm_bytes = n * PAGE
                        if install is not None:
                            install.install_block(pages, block)
                        else:
                            for i, h in enumerate(hashes):
                                if h not in chunks:
                                    chunks[h] = block[i].tobytes()
                    finally:
                        # The numpy view exports a pointer into the
                        # mapping; it must die before view.close().
                        del block
                else:
                    for c in manifest["chunks"]:
                        blk = bytes(view.chunk(c["off"], c["len"]))
                        if chunk_hash(blk) != c["h"]:
                            raise ChunkHashMismatchError(
                                f"chunk {c['h']} of {base} corrupt in shm")
                        chunks[c["h"]] = blk
                        shm_bytes += c["len"]
            finally:
                view.close()
                tx += send_frame(self._sock, T_RELEASE)
        elif transport == "inline" and manifest.get("chunks"):
            cgot = recv_frame(self._sock)
            ctype, blob = cgot
            rx += HEADER.size + len(blob)
            if ctype != T_CHUNKS:
                raise WireError(f"expected CHUNKS, got frame type {ctype}")
            for c in manifest["chunks"]:
                blk = decode_chunk(c["enc"], blob[c["off"]:c["off"] + c["len"]])
                if chunk_hash(blk) != c["h"]:
                    raise ChunkHashMismatchError(
                        f"chunk {c['h']} of {base} corrupt on wire")
                chunks[c["h"]] = blk
            with self.stats._mu:
                self.stats.inline_bytes += len(blob)

        full_shm = transport == "shm" and manifest.get("layout") == "full"
        if install is not None and not full_shm:
            # Small/deduped pull that came back inline: assemble the
            # page-ordered block and install in one scatter.  (The shm
            # full layout already installed straight from the mapping.)
            blob = b"".join(chunks[h] for h in hashes)
            block = np.frombuffer(blob, dtype=np.uint8).reshape(-1, PAGE)
            install.install_block(pages, block)

        rtt = time.monotonic() - t0
        with self.stats._mu:
            self.stats.fetches += 1
            self.stats.wire_tx_bytes += tx
            self.stats.wire_rx_bytes += rx
            self.stats.shm_bytes += shm_bytes
            if not full_shm:
                self.stats.dedup_chunks_skipped += len(set(hashes)) - len(chunks)
        self.stats.record_rtt(rtt)
        return FetchResult(base=base, pages=pages, hashes=hashes,
                           transport=transport, chunks=chunks,
                           wire_bytes=tx + rx, shm_bytes=shm_bytes,
                           rtt_s=rtt)
