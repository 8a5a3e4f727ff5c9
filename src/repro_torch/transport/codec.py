"""Per-chunk wire compression for the page transport.

A WS chunk is one 4 KiB arena page.  Model-weight pages (structured
floats, zero runs, repeated embeddings) compress well; already-dense
pages (random-looking bf16 mantissas) do not, and running zlib over them
wastes CPU on both ends of the wire.  The codec therefore decides *per
chunk* with a cheap entropy probe: a byte histogram over a strided
sample of the chunk, skip compression when the sampled entropy says the
chunk is effectively incompressible, and fall back to raw whenever the
encoded form would not actually be smaller.

The compressor is lz4 when importable ("lz4-style": fast, low ratio),
else zlib level 1 — the container bakes no lz4, so zlib-1 is the
portable floor.  This module supersedes ``distributed/compress.py`` as
the reference for wire-compression accounting: stats split compressed
vs raw chunk counts and logical vs wire bytes, so benchmarks can report
the ratio without re-deriving it from transfer counters.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import zlib

try:                                  # optional; absent in the base image
    import lz4.frame as _lz4
except ImportError:                   # pragma: no cover - environment detail
    _lz4 = None

ENC_RAW = "raw"
ENC_ZLIB = "zlib"
ENC_LZ4 = "lz4"

#: Sampled bits/byte above which a chunk is treated as incompressible.
#: 8.0 is a uniformly random byte stream; dense float pages probe ~7.5+.
ENTROPY_SKIP_BITS = 7.2

#: Histogram sample size (bytes, strided over the chunk).  512 of 4096
#: keeps the probe ~8x cheaper than hashing the chunk.
PROBE_SAMPLE = 512


def probe_entropy(block: bytes, sample: int = PROBE_SAMPLE) -> float:
    """Shannon entropy (bits/byte) of a strided byte sample of ``block``."""
    n = len(block)
    if n == 0:
        return 0.0
    step = max(n // sample, 1)
    counts: dict[int, int] = {}
    total = 0
    for i in range(0, n, step):
        b = block[i]
        counts[b] = counts.get(b, 0) + 1
        total += 1
    ent = 0.0
    for c in counts.values():
        p = c / total
        ent -= p * math.log2(p)
    return ent


def encode_chunk(block: bytes, *, compress: bool = True,
                 level: int = 1) -> tuple[str, bytes]:
    """``(encoding, payload)`` for one chunk.

    ``compress=False`` (the raw-socket arm) always ships raw.  Otherwise
    the entropy probe gates the compressor, and an encoded form that is
    not strictly smaller than the chunk ships raw anyway (the decoder
    must never pay inflation for a chunk the probe misjudged).
    """
    if not compress or probe_entropy(block) >= ENTROPY_SKIP_BITS:
        return ENC_RAW, block
    if _lz4 is not None:
        packed = _lz4.compress(block)
        enc = ENC_LZ4
    else:
        packed = zlib.compress(block, level)
        enc = ENC_ZLIB
    if len(packed) >= len(block):
        return ENC_RAW, block
    return enc, packed


def decode_chunk(enc: str, payload: bytes) -> bytes:
    if enc == ENC_RAW:
        return payload
    if enc == ENC_ZLIB:
        return zlib.decompress(payload)
    if enc == ENC_LZ4:
        if _lz4 is None:
            raise ValueError("lz4-encoded chunk but lz4 is not importable")
        return _lz4.decompress(payload)
    raise ValueError(f"unknown chunk encoding {enc!r}")


@dataclasses.dataclass
class CodecStats:
    """Compressed/raw split for one endpoint's chunk traffic.

    ``logical_bytes`` counts pre-codec chunk bytes, ``wire_bytes`` the
    encoded bytes actually framed; ``ratio`` is their quotient (1.0 for
    an all-raw stream).  Thread-safe: wire handler threads record into
    one instance per server/client.
    """
    raw_chunks: int = 0
    compressed_chunks: int = 0
    logical_bytes: int = 0
    wire_bytes: int = 0

    def __post_init__(self) -> None:
        self._mu = threading.Lock()

    def record(self, enc: str, logical: int, wire: int) -> None:
        with self._mu:
            if enc == ENC_RAW:
                self.raw_chunks += 1
            else:
                self.compressed_chunks += 1
            self.logical_bytes += logical
            self.wire_bytes += wire

    def ratio(self) -> float:
        with self._mu:
            return (self.logical_bytes / self.wire_bytes
                    if self.wire_bytes else 1.0)

    def as_dict(self) -> dict:
        with self._mu:
            out = {"raw_chunks": self.raw_chunks,
                   "compressed_chunks": self.compressed_chunks,
                   "logical_bytes": self.logical_bytes,
                   "wire_bytes": self.wire_bytes}
        out["compress_ratio"] = round(
            out["logical_bytes"] / out["wire_bytes"], 4) \
            if out["wire_bytes"] else 1.0
        return out
