"""Real inter-process page transport.

Everything that touches a raw ``socket`` or a
``multiprocessing.shared_memory`` segment lives behind this package
(lint REP008): the rest of the tree talks chunks and manifests, never
file descriptors.

  * :mod:`~repro_torch.transport.codec` — per-chunk wire compression (raw vs
    zlib level 1, chosen by a cheap entropy probe).
  * :mod:`~repro_torch.transport.wire` — length-prefixed framed protocol over
    Unix-domain sockets: chunk-hash negotiation, shm descriptors or
    inline payloads, per-chunk hash verification on receive.
  * :mod:`~repro_torch.transport.shm` — the shared-memory data plane the wire
    rides for large transfers (zero-copy ``install_block`` installs).
  * :mod:`~repro_torch.transport.procnode` — process-per-node fleet harness:
    a ``WorkerNode`` per child process with a private WS cache and a
    transport server, plus a supervisor speaking the ``ClusterRouter``
    scheduling interface (``build_fleet(transport="socket")``).
"""
from .codec import CodecStats, decode_chunk, encode_chunk
from .shm import shm_available
from .wire import (BadMagicError, ChunkHashMismatchError, PageClient,
                   PageServer, TruncatedFrameError, WireError)

__all__ = [
    "BadMagicError", "ChunkHashMismatchError", "CodecStats", "PageClient",
    "PageServer", "TruncatedFrameError", "WireError", "decode_chunk",
    "encode_chunk", "shm_available",
]
