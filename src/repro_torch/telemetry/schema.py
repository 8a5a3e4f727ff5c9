"""The one documented stat-key schema.

Historically the serving and benchmark layers drifted: ``Router.summarize``
said ``ws_cache_hits`` while the scalability CSV's derived column said
``ws_hits`` and one benchmark metric block said ``ws_cache_hit_rate``.
This module pins the canonical names; readers that still hold artifacts
written with the old keys go through :func:`canonicalize`.

Canonical keys
==============

Summary blocks (``Router.summarize`` and per-arm benchmark metrics)::

    n                  invocations summarized
    queue_mean_s       mean router queue wait (seconds)
    queue_p95_s        p95 router queue wait
    total_mean_s       mean restore+execute time
    e2e_p50_s          median end-to-end latency
    e2e_p95_s          p95 end-to-end latency
    ws_cache_hits      cold starts served from the shared WS page cache
    ws_cache_hit_rate  hits / (hits + misses) over the run's cache lookups
    cold               cold starts
    cold_fraction      cold / n  — lives at the TOP LEVEL of each summary
                       or per-arm metrics block, never nested
    prewarmed          serves that hit a policy-prewarmed instance
    batched            cold starts restored as part of a fused group
    install_mean_s     mean eager-install seconds
    stage_seconds      per-stage mean seconds (StageTimings field names)
    tail_waits         arena faults that blocked on an in-flight tail
    tail_wait_mean_s   mean seconds spent in those waits

Node stats (``WorkerNode.stats``)::

    node, alive, capacity, load
    warm_instances     {function: idle warm instances} (per-node warm counts)
    router             Router.stats()
    stage_seconds      Orchestrator.stage_seconds()
    tails              Orchestrator.tail_stats()
    ws_cache           WSCache.stats() (when the node owns a private cache)
    policy             PrewarmPolicy.stats() (when a policy is attached)

Content-addressed page store (``PageStore.stats`` — core/pagestore.py,
and the shard tier's ``ShardedSnapshotStore.stats``)::

    store_bytes        live unique-chunk bytes held by the chunk store
    data_bytes         chunks.data file bytes (live + dead, pre-compaction)
    logical_bytes      flat-file-equivalent WS bytes across live manifests
    dedup_ratio        logical_bytes / store_bytes (1.0 for an empty store);
                       >1 means cross-function/intra-WS page sharing
    delta_chunks       chunks a re-record actually appended (delta writes);
                       unchanged pages show up as dedup_hits instead
    dedup_hits         manifest chunks already present at write time
    transfer_bytes     shard-tier bytes shipped — ONLY chunks the
                       requester's L1 was missing (actual-missing charge)
    dedup_bytes_saved  WS bytes a remote fetch did NOT ship because the
                       requester already held the chunks (any function)

Node transport stats (``nodes.<id>.transport`` in a socket-fleet
``ProcessFleet.stats`` — repro_torch.transport; absent on inproc fleets, and
readers must render a placeholder then)::

    wire_tx_bytes      socket bytes this node put on the wire (frames,
                       client + server side)
    wire_rx_bytes      socket bytes received (frames, both sides)
    shm_bytes          chunk bytes that rode shared-memory segments
    inline_bytes       encoded chunk bytes that rode the socket inline
    raw_chunks         inline chunks shipped unencoded (server codec)
    compressed_chunks  inline chunks shipped compressed
    compress_ratio     logical / wire bytes over the codec'd stream
                       (1.0 for an all-raw or idle stream)
    fetch_rtt_s        {count, sum, p50, p95} of this node's WS-fetch
                       round-trips (negotiate + ship + verify)
    remote_fetches     L1 misses served by a peer's PageServer
    remote_misses      owner dialed but cold (no WS entry to serve)
    origin_reads       fetches that fell through to the origin disk
    dead_owner_fallbacks  fetches where a dead peer (connection refused/
                       reset) forced the origin fallback
    chunks_served      chunks this node's PageServer shipped to peers
    shm_responses / inline_responses  server responses by data plane

Snapshotter samples (one JSON object per line, see
:class:`repro_torch.telemetry.StatsSnapshotter`)::

    t        sample timestamp in the snapshotter's injected-clock domain
    seq      monotonically increasing sample index
    sources  {source_name: that source's stats() dict, or
              {"error": repr} when the source raised}
    errors   cumulative count of source failures so far
"""
from __future__ import annotations

__all__ = ["SAMPLE_KEYS", "LEGACY_ALIASES", "canonicalize"]

#: Keys present in *every* snapshotter sample (schema-stability contract).
SAMPLE_KEYS = ("t", "seq", "sources", "errors")

#: legacy key -> canonical key.  Readers of old artifacts map through
#: :func:`canonicalize`; writers must only emit canonical names.
LEGACY_ALIASES = {
    "ws_hits": "ws_cache_hits",
    "ws_cache_hit": "ws_cache_hits",
    "ws_hit_rate": "ws_cache_hit_rate",
    "warm_counts": "warm_instances",
}


def canonicalize(obj):
    """Recursively rename legacy stat keys to their canonical names.

    Canonical keys win on collision (an artifact carrying both spellings
    keeps the canonical value).  Lists are mapped element-wise; scalars
    pass through untouched.
    """
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            ck = LEGACY_ALIASES.get(k, k)
            if ck in out and ck != k:
                continue  # canonical spelling already present
            out[ck] = canonicalize(v)
        return out
    if isinstance(obj, list):
        return [canonicalize(v) for v in obj]
    return obj
