"""The paper's primary contribution: snapshot arena + REAP record/prefetch.

  arena.py    -- guest-memory-file format + demand-paged InstanceArena
  pagestore.py-- content-addressed chunk store behind the WS records
  snapshot.py -- booted-instance image builder (infra/serve/boot regions)
  reap.py     -- trace + WS files, record & prefetch phases, re-record policy
  restore.py  -- staged RestorePipeline + batched RestoreBatch group restores
  executor.py -- model-aware fault-scheduling invocation executor
"""
from .arena import PAGE, ArenaLayout, GuestMemoryFile, InstanceArena, PageSource
from .executor import run_invocation
from .reap import (WS_CACHE, ColdStartReport, Monitor, ReapConfig, WSCache,
                   has_record, prefetch, prefetch_shared,
                   register_invalidation_listener,
                   unregister_invalidation_listener, write_record)
from .restore import (STAGES, RestoreBatch, RestorePipeline, StageTimings,
                      TailInstall, fuse_ws_block)
from .snapshot import booted_footprint_bytes, build_instance_snapshot
