"""Process-per-node fleet: real address spaces, real page movement.

The inproc fleet (cluster/scheduler.py) is threads in one heap — its
"transfers" are numpy references and a :class:`TransferModel` sleep.
This harness runs each :class:`~repro_torch.cluster.node.WorkerNode` in its
own **child process** with a private ``WSCache``, so a WS moving between
nodes must actually cross an address-space boundary:

  * every child runs a :class:`~repro_torch.transport.wire.PageServer` over a
    Unix-domain socket, serving its L1 via ``peek_chunks``;
  * a child's L1 miss resolves through :class:`TransportSource` — it
    dials the function's owner shards (same consistent-hash ring, built
    independently but deterministically in every process), negotiates
    the chunk diff against its own L1 index, and reassembles the WS from
    shipped + locally-held chunks; dead owners fall back to the origin
    read exactly like the inproc shard tier (``dead_owner_fallbacks``);
  * the supervisor (:class:`ProcessFleet`) speaks the same scheduling
    interface as :class:`~repro_torch.cluster.ClusterRouter` — submit/invoke/
    map/register/rebalance/kill_node/stats — so
    ``build_fleet(..., transport="socket")`` A/Bs the two fleets on
    identical traces.

Children are ``spawn``ed (fork is unsafe once CUDA or threads have
started) and controlled over a ``multiprocessing.Pipe``: small sync RPCs
for control and signals, a two-phase submit (sync admission ack, async
result) for the data plane.  Each child checks its ``ServeConfig``'s
device itself and computes there: a child that cannot reach the card
fails, it never serves on the CPU.  Invocation outputs come back as CPU
tensors of the child's dtype (the pipe pickles a tensor with its dtype
and bits, bfloat16 included), so the byte-parity check against the
inproc fleet is exact.  The ``stats`` RPC adds the
child's kernel launch counts (``kernel_launches``): counts are kept per
process.
"""
from __future__ import annotations

import dataclasses
import multiprocessing as mp
import os
import tempfile
import threading
import time
import traceback

import numpy as np

from ..cluster.scheduler import ScheduleConfig
from ..cluster.shardmap import ConsistentHashRing
from .wire import FETCH_TIMEOUT_S, PageClient, PageServer, WireError, percentiles


class FleetNodeDownError(RuntimeError):
    """The child process backing this node is gone."""


@dataclasses.dataclass
class NodeSpec:
    """Everything a child needs to assemble its node (must pickle)."""
    node_id: str
    store_dir: str
    sock_dir: str
    node_ids: tuple[str, ...]        # full fleet, for the local ring copy
    config: object                   # ServeConfig (telemetry/demand stripped)
    replication: int = 1
    vnodes: int = 64
    cache_capacity_bytes: int = 256 << 20
    transport_compress: bool = False
    transport_shm: bool = True
    transport_inline_max: int = 64 << 10

    def sock_path(self, node_id: str) -> str:
        return os.path.join(self.sock_dir, f"{node_id}.sock")


class TransportSource:
    """A child L1's miss resolver: owner sockets first, origin disk last.

    Mirrors ``ShardedSnapshotStore._shard_fetch``'s accounting — remote
    fetch / cold-owner miss / dead-owner fallback / origin read — but
    the bytes actually move: the owner's PageServer ships the chunk diff
    over shm or the socket, and this side reassembles from shipped plus
    locally-held chunks.
    """

    def __init__(self, spec: NodeSpec, ring: ConsistentHashRing, *,
                 timeout_s: float = FETCH_TIMEOUT_S):
        self.spec = spec
        self.ring = ring
        #: each owner's PageClient bound: an owner that is alive but does
        #: not answer within it is treated as dead (origin read)
        self.timeout_s = timeout_s
        self.cache = None            # wired after WSCache construction
        self._clients: dict[str, PageClient] = {}
        self._mu = threading.Lock()
        self.remote_fetches = 0
        self.remote_misses = 0
        self.origin_reads = 0
        self.dead_owner_fallbacks = 0

    def _client(self, owner: str) -> PageClient:
        with self._mu:
            cli = self._clients.get(owner)
        if cli is None:
            cli = PageClient(self.spec.sock_path(owner), timeout_s=self.timeout_s)
            with self._mu:
                self._clients[owner] = cli
        return cli

    def _drop_client(self, owner: str) -> None:
        with self._mu:
            cli = self._clients.pop(owner, None)
        if cli is not None:
            cli.close()

    def _assemble(self, result) -> bytes:
        held = [h for h in result.hashes if h not in result.chunks]
        local = (self.cache.chunk_payloads(held)
                 if self.cache is not None and held else {})
        return result.assemble(lookup=local.get)

    def __call__(self, base: str, cfg, group: int = 1):
        name = os.path.basename(base)
        owners = self.ring.lookup(name, self.spec.replication)
        any_dead = False
        for owner in owners:
            if owner == self.spec.node_id:
                continue             # own L1 already missed
            try:
                cli = self._client(owner)
                have = (self.cache.chunk_index()
                        if self.cache is not None else ())
                result = cli.fetch(base, have)
                if result is None:
                    with self._mu:
                        self.remote_misses += 1
                    continue         # owner is cold: try next replica
                try:
                    data = self._assemble(result)
                except KeyError:
                    # a locally-held chunk was evicted between the index
                    # digest and reassembly: refetch without negotiation
                    result = cli.fetch(base, ())
                    if result is None:
                        with self._mu:
                            self.remote_misses += 1
                        continue
                    data = self._assemble(result)
            except (WireError, OSError):
                # owner process is gone (or mid-death): drop the broken
                # connection and treat it like a dead shard
                self._drop_client(owner)
                any_dead = True
                continue
            with self._mu:
                self.remote_fetches += 1
            return [int(p) for p in result.pages], data
        if any_dead:
            with self._mu:
                self.dead_owner_fallbacks += 1
        from ..core.reap import _read_ws
        pages, data = _read_ws(base, cfg)
        with self._mu:
            self.origin_reads += 1
        return pages, data

    def stats(self) -> dict:
        with self._mu:
            out = {"remote_fetches": self.remote_fetches,
                   "remote_misses": self.remote_misses,
                   "origin_reads": self.origin_reads,
                   "dead_owner_fallbacks": self.dead_owner_fallbacks}
            clients = list(self._clients.values())
        merged: dict = {}
        rtts: list[float] = []
        waits: list[float] = []
        for cli in clients:
            d = cli.stats.as_dict()
            d.pop("fetch_rtt_s")
            with cli.stats._mu:
                rtts.extend(cli.stats._rtts)
                waits.extend(cli.stats._waits)
            for k, v in d.items():
                merged[k] = merged.get(k, 0) + v
        out.update(merged)
        out["fetch_rtt_s"] = percentiles(rtts)
        out["fetch_wait_s"] = percentiles(waits)
        return out

    def reset_stats(self) -> None:
        with self._mu:
            self.remote_fetches = self.remote_misses = 0
            self.origin_reads = self.dead_owner_fallbacks = 0
            clients = list(self._clients.values())
        for cli in clients:
            with cli.stats._mu:
                for k in ("fetches", "misses", "wire_tx_bytes",
                          "wire_rx_bytes", "shm_bytes", "inline_bytes",
                          "dedup_chunks_skipped"):
                    setattr(cli.stats, k, 0)
                cli.stats._rtts.clear()
                cli.stats._waits.clear()

    def close(self) -> None:
        with self._mu:
            clients = list(self._clients.values())
            self._clients.clear()
        for cli in clients:
            cli.close()


# --------------------------------------------------------------- child side

def _node_main(spec: NodeSpec, conn) -> None:
    """Child entry point: build node + transport, serve the control pipe."""
    from ..cluster.node import WorkerNode
    from ..core.reap import WSCache
    from ..kernels import LAUNCHES, reset_launches

    # unpickling skipped ServeConfig.__post_init__: rebuilding the config
    # runs its device check here, in the process that will use the device
    config = dataclasses.replace(spec.config)
    ring = ConsistentHashRing(spec.node_ids, vnodes=spec.vnodes)
    source = TransportSource(spec, ring)
    cache = WSCache(spec.cache_capacity_bytes, source=source)
    source.cache = cache
    node = WorkerNode(spec.node_id, spec.store_dir, config, ws_cache=cache)
    server = PageServer(spec.sock_path(spec.node_id),
                        lambda base: cache.peek_chunks(base),
                        inline_max_bytes=spec.transport_inline_max,
                        compress=spec.transport_compress,
                        use_shm=spec.transport_shm)
    send_mu = threading.Lock()

    def reply(rid, kind, payload=None):
        with send_mu:
            try:
                conn.send((rid, kind, payload))
            except (OSError, ValueError, BrokenPipeError):
                pass                 # supervisor gone: nothing to tell

    def _wait_result(rid, inv):
        try:
            out, report = inv.result()
            reply(rid, "result", (out.detach().cpu(), report))
        except BaseException as e:
            reply(rid, "result_err", _shippable(e))

    def transport_stats() -> dict:
        out = source.stats()
        srv = server.stats.as_dict()
        out["wire_tx_bytes"] = out.get("wire_tx_bytes", 0) + srv["wire_tx_bytes"]
        out["wire_rx_bytes"] = out.get("wire_rx_bytes", 0) + srv["wire_rx_bytes"]
        out["chunks_served"] = srv["chunks_shipped"]
        out["serve_prep_s"] = server.stats.prep_percentiles()
        out["shm_responses"] = srv["shm_responses"]
        out["inline_responses"] = srv["inline_responses"]
        codec = server.codec.as_dict()
        out["raw_chunks"] = codec["raw_chunks"]
        out["compressed_chunks"] = codec["compressed_chunks"]
        out["compress_ratio"] = codec["compress_ratio"]
        return out

    running = True
    while running:
        try:
            rid, op, args = conn.recv()
        except (EOFError, OSError):
            break                    # supervisor died: shut down
        try:
            if op == "register":
                name, cfg, seed, warmup = args
                node.register(name, cfg, seed=seed, warmup_batch=warmup)
                reply(rid, "ok")
            elif op == "submit":
                name, batch, force_cold = args
                inv = node.submit(name, batch, force_cold=force_cold)
                reply(rid, "ok")     # admitted; result streams back later
                threading.Thread(target=_wait_result, args=(rid, inv),
                                 daemon=True).start()
            elif op == "signals":
                (name,) = args
                reply(rid, "ok", (node.alive, node.load(),
                                  node.warm_count(name),
                                  node.ws_resident(name), node.capacity))
            elif op == "stats":
                s = node.stats()
                s["transport"] = transport_stats()
                s["kernel_launches"] = dict(LAUNCHES)
                reply(rid, "ok", s)
            elif op == "warm_owner":
                (base,) = args
                from ..core.reap import has_record
                if has_record(base):
                    cache.fetch(base, node.config.resolved_reap())
                    reply(rid, "ok", True)
                else:
                    reply(rid, "ok", False)
            elif op == "scale_to_zero":
                (name,) = args
                node.orch.scale_to_zero(name)
                reply(rid, "ok")
            elif op == "clear_cache":
                cache.clear()
                reply(rid, "ok")
            elif op == "reset_stats":
                cache.reset_stats()
                source.reset_stats()
                reset_launches()
                reply(rid, "ok")
            elif op == "push_forecast":
                node.push_forecast(*args)
                reply(rid, "ok")
            elif op == "clear_forecast":
                node.clear_forecast(*args)
                reply(rid, "ok")
            elif op == "drain":
                (timeout,) = args
                node.router.drain(timeout)
                reply(rid, "ok")
            elif op == "close":
                node.close()
                server.close()
                source.close()
                reply(rid, "ok")
                running = False
            else:
                reply(rid, "err", ValueError(f"unknown op {op!r}"))
        except BaseException as e:
            reply(rid, "err", _shippable(e))
    try:
        conn.close()
    except OSError:
        pass


def _shippable(e: BaseException) -> BaseException:
    """Exceptions cross the pipe; one that can't pickle becomes a
    RuntimeError carrying its traceback text."""
    try:
        import pickle
        pickle.dumps(e)
        return e
    except Exception:
        return RuntimeError(
            "".join(traceback.format_exception(type(e), e, e.__traceback__)))


# ---------------------------------------------------------- supervisor side

class FleetInvocation:
    """Future for one socket-fleet invocation (two-phase submit)."""

    def __init__(self, fleet: "ProcessFleet", name: str, batch: dict,
                 force_cold: bool):
        self._fleet = fleet
        self.name = name
        self.batch = batch
        self.force_cold = force_cold
        self.node_ids: list[str] = []
        self._ev = threading.Event()
        self._out = None
        self._err: BaseException | None = None

    def _resolve(self, out=None, err=None) -> None:
        self._out, self._err = out, err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set() and not isinstance(
            self._err, FleetNodeDownError)

    def result(self, timeout: float | None = None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            left = (None if deadline is None
                    else max(deadline - time.monotonic(), 0.0))
            if not self._ev.wait(left):
                raise TimeoutError(f"{self.name}: no result in {timeout}s")
            if self._err is None:
                return self._out
            if isinstance(self._err, FleetNodeDownError):
                # placement died: reroute onto a survivor and wait again
                self._ev.clear()
                self._fleet._reroute(self)
                continue
            raise self._err

    @property
    def report(self):
        return self.result()[1]


class ProcessNode:
    """Supervisor-side proxy for one child process."""

    def __init__(self, spec: NodeSpec, ctx):
        self.node_id = spec.node_id
        self.spec = spec
        self.capacity = 4            # refreshed from the first signals RPC
        self.alive = True
        self._conn, child_conn = ctx.Pipe()
        self._proc = ctx.Process(target=_node_main, args=(spec, child_conn),
                                 name=f"procnode-{spec.node_id}", daemon=True)
        self._proc.start()
        child_conn.close()
        self._mu = threading.Lock()
        self._next_rid = 0
        self._waiters: dict[int, dict] = {}   # rid -> {"ev", "kind", "payload"}
        self._invs: dict[int, FleetInvocation] = {}
        self._reader = threading.Thread(target=self._read_loop,
                                        name=f"procnode-rx-{spec.node_id}",
                                        daemon=True)
        self._reader.start()

    # -- pipe plumbing

    def _read_loop(self) -> None:
        while True:
            try:
                rid, kind, payload = self._conn.recv()
            except (EOFError, OSError):
                break
            if kind in ("result", "result_err"):
                with self._mu:
                    inv = self._invs.pop(rid, None)
                if inv is not None:
                    if kind == "result":
                        out, report = payload
                        inv._resolve(out=(out, report))
                    else:
                        inv._resolve(err=payload)
                continue
            with self._mu:
                w = self._waiters.pop(rid, None)
            if w is not None:
                w["kind"], w["payload"] = kind, payload
                w["ev"].set()
        self._fail_pending()

    def _fail_pending(self) -> None:
        self.alive = False
        with self._mu:
            waiters = list(self._waiters.values())
            self._waiters.clear()
            invs = list(self._invs.values())
            self._invs.clear()
        for w in waiters:
            w["kind"], w["payload"] = "down", None
            w["ev"].set()
        for inv in invs:
            inv._resolve(err=FleetNodeDownError(
                f"node {self.node_id} died mid-invocation"))

    def _call(self, op: str, *args, timeout: float = 300.0,
              inv: FleetInvocation | None = None):
        if not self.alive:
            raise FleetNodeDownError(f"node {self.node_id} is down")
        w = {"ev": threading.Event(), "kind": None, "payload": None}
        with self._mu:
            rid = self._next_rid
            self._next_rid += 1
            self._waiters[rid] = w
            if inv is not None:
                self._invs[rid] = inv
            try:
                self._conn.send((rid, op, args))
            except (OSError, ValueError, BrokenPipeError) as e:
                self._waiters.pop(rid, None)
                self._invs.pop(rid, None)
                raise FleetNodeDownError(
                    f"node {self.node_id} pipe is closed") from e
        if not w["ev"].wait(timeout):
            with self._mu:
                self._waiters.pop(rid, None)
            raise TimeoutError(f"{self.node_id}: {op} RPC timed out")
        if w["kind"] == "down":
            with self._mu:
                self._invs.pop(rid, None)
            raise FleetNodeDownError(f"node {self.node_id} died during {op}")
        if w["kind"] == "err":
            with self._mu:
                self._invs.pop(rid, None)
            raise w["payload"]
        return w["payload"]

    # -- WorkerNode-shaped surface

    def register(self, name, cfg, *, seed=0, warmup_batch=None,
                 timeout=600.0):
        return self._call("register", name, cfg, seed, warmup_batch,
                          timeout=timeout)

    def submit(self, name: str, batch: dict, inv: FleetInvocation, *,
               force_cold: bool = False) -> None:
        """Two-phase: this call returns once the child *admitted* the
        invocation (AdmissionError raises here, synchronously, like the
        inproc node); the result resolves ``inv`` later."""
        self._call("submit", name, batch, force_cold, inv=inv)
        inv.node_ids.append(self.node_id)

    def signals(self, name: str) -> tuple:
        alive, load, warm, ws_res, cap = self._call("signals", name,
                                                    timeout=30.0)
        self.capacity = cap
        return alive, load, warm, ws_res

    def stats(self) -> dict:
        return self._call("stats", timeout=60.0)

    def warm_owner(self, base: str) -> bool:
        return self._call("warm_owner", base)

    def scale_to_zero(self, name: str) -> None:
        self._call("scale_to_zero", name)

    def clear_cache(self) -> None:
        self._call("clear_cache")

    def reset_stats(self) -> None:
        self._call("reset_stats")

    def push_forecast(self, name, rate_rps, expires_at) -> None:
        self._call("push_forecast", name, rate_rps, expires_at, timeout=30.0)

    def clear_forecast(self, name) -> None:
        self._call("clear_forecast", name, timeout=30.0)

    def drain(self, timeout: float | None = None) -> None:
        self._call("drain", timeout,
                   timeout=(timeout or 300.0) + 30.0)

    def kill(self) -> None:
        """Hard host failure: SIGTERM the child.  Its PageServer socket
        dies with it, so peers mid-fetch see connection errors and take
        the dead-owner fallback; pending invocations here resolve with
        FleetNodeDownError and reroute."""
        self.alive = False
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=10.0)
        self._fail_pending()

    def close(self) -> None:
        if self.alive:
            try:
                self._call("close", timeout=120.0)
            except (FleetNodeDownError, TimeoutError):
                pass
        self.alive = False
        self._proc.join(timeout=30.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=10.0)
        try:
            self._conn.close()
        except OSError:
            pass


class ProcessFleet:
    """Supervisor speaking the ClusterRouter scheduling interface over a
    fleet of child processes.

    Placement reuses :class:`~repro_torch.cluster.ScheduleConfig` scoring —
    warm instances, WS residency, shard ownership, load — but reads the
    signals with one RPC per node instead of an in-heap method call.
    """

    def __init__(self, nodes: list[ProcessNode], *,
                 cfg: ScheduleConfig | None = None,
                 replication: int = 1, vnodes: int = 64,
                 sock_dir: str | None = None):
        self.cfg = cfg or ScheduleConfig()
        self.nodes: dict[str, ProcessNode] = {n.node_id: n for n in nodes}
        self.ring = ConsistentHashRing(tuple(self.nodes), vnodes=vnodes)
        self.replication = replication
        self._sock_dir = sock_dir
        self._functions: dict[str, tuple] = {}
        self._mu = threading.Lock()
        self.store = None            # no in-heap shard tier: data is remote
        self.demand_plane = None
        self.telemetry = None
        self.n_placed = 0
        self.n_rerouted = 0
        self.n_rejected = 0
        self.placements: dict[str, int] = {n: 0 for n in self.nodes}

    # -- membership / control plane

    def alive_nodes(self) -> list[ProcessNode]:
        return [n for n in self.nodes.values() if n.alive]

    def register(self, name, cfg, *, seed=0, warmup_batch=None,
                 replication=None) -> None:
        """Register fleet-wide.  Sequential on purpose: the first child
        builds the snapshot in the shared store_dir, the rest reuse it
        read-only (racing children could double-build).  Each child gets
        the warm-up batch: kernels load, and the warm-up forward runs, in
        each process."""
        with self._mu:
            self._functions[name] = (cfg, seed)
        for node in self.alive_nodes():
            node.register(name, cfg, seed=seed, warmup_batch=warmup_batch)

    def rebalance(self) -> dict[str, int]:
        """Pull each function's WS into its owner shards' child caches."""
        with self._mu:
            names = list(self._functions)
        store_dirs = {n.spec.store_dir for n in self.nodes.values()}
        warmed = {}
        for name in names:
            owners = self.ring.lookup(name, self.replication)
            n = 0
            for owner in owners:
                node = self.nodes.get(owner)
                if node is None or not node.alive:
                    continue
                for d in store_dirs:
                    if node.warm_owner(os.path.join(d, name)):
                        n += 1
            warmed[name] = n
        return warmed

    def kill_node(self, node_id: str) -> int:
        node = self.nodes[node_id]
        self.ring.remove(node_id)
        node.kill()
        return 0                     # reroutes happen lazily in result()

    # -- placement

    def rank(self, name: str) -> list[ProcessNode]:
        alive = self.alive_nodes()
        if not alive:
            return []
        owners = set(self.ring.lookup(name, self.replication))
        c = self.cfg
        scored = []
        for n in alive:
            try:
                up, load, warm, ws_res = n.signals(name)
            except (FleetNodeDownError, TimeoutError):
                continue
            if not up:
                continue
            s = 0.0
            if warm > 0:
                s += c.w_warm
            if ws_res:
                s += c.w_ws
            if n.node_id in owners:
                s += c.w_owner
            s -= c.w_load * load / max(n.capacity, 1)
            scored.append((-s, load, n.node_id, n))
        scored.sort(key=lambda t: (t[0], t[1], t[2]))
        return [t[3] for t in scored]

    def _submit_once(self, inv: FleetInvocation) -> None:
        from ..serving import AdmissionError
        admission = None
        for node in self.rank(inv.name):
            try:
                node.submit(inv.name, inv.batch, inv,
                            force_cold=inv.force_cold)
            except AdmissionError as e:
                admission = e
                continue
            except (FleetNodeDownError, TimeoutError):
                continue
            with self._mu:
                self.n_placed += 1
                self.placements[node.node_id] = (
                    self.placements.get(node.node_id, 0) + 1)
            return
        if admission is not None:
            with self._mu:
                self.n_rejected += 1
            raise admission
        raise FleetNodeDownError("no alive nodes in the fleet")

    def _reroute(self, inv: FleetInvocation) -> None:
        with self._mu:
            self.n_rerouted += 1
        if len(inv.node_ids) > self.cfg.max_reroutes:
            inv._resolve(err=RuntimeError(
                f"{inv.name}: reroute budget exhausted ({inv.node_ids})"))
            return
        try:
            self._submit_once(inv)
        except BaseException as e:
            inv._resolve(err=e)

    # -- client API

    def submit(self, name: str, batch: dict, *,
               force_cold: bool = False) -> FleetInvocation:
        inv = FleetInvocation(self, name, batch, force_cold)
        self._submit_once(inv)
        return inv

    def invoke(self, name: str, batch: dict, *, force_cold: bool = False,
               timeout: float | None = None):
        return self.submit(name, batch, force_cold=force_cold).result(timeout)

    def map(self, items, *, force_cold: bool = False) -> list:
        invs = [self.submit(n, b, force_cold=force_cold) for n, b in items]
        return [inv.result() for inv in invs]

    # -- maintenance / observability

    def drain(self, timeout: float | None = None) -> None:
        for node in self.alive_nodes():
            node.drain(timeout)

    def scale_to_zero(self, name: str) -> None:
        for node in self.alive_nodes():
            node.scale_to_zero(name)

    def clear_caches(self) -> None:
        for node in self.alive_nodes():
            node.clear_cache()

    def reset_stats(self) -> None:
        with self._mu:
            self.n_placed = self.n_rerouted = self.n_rejected = 0
            self.placements = {n: 0 for n in self.nodes}
        for node in self.alive_nodes():
            node.reset_stats()

    def stats(self) -> dict:
        with self._mu:
            out = {"placement": self.cfg.placement,
                   "placed": self.n_placed,
                   "rerouted": self.n_rerouted,
                   "rejected": self.n_rejected,
                   "placements": dict(self.placements),
                   "transport": "socket"}
        out["nodes"] = {}
        for node in self.alive_nodes():
            try:
                out["nodes"][node.node_id] = node.stats()
            except (FleetNodeDownError, TimeoutError):
                continue
        return out

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.close()
        for node in self.nodes.values():
            node.close()
        if self._sock_dir is not None:
            try:
                for f in os.listdir(self._sock_dir):
                    os.unlink(os.path.join(self._sock_dir, f))
                os.rmdir(self._sock_dir)
            except OSError:
                pass

    def __enter__(self) -> "ProcessFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_process_fleet(n_nodes: int, store_dir: str, *,
                        config=None, cfg: ScheduleConfig | None = None,
                        replication: int = 1, vnodes: int = 64,
                        cache_capacity_bytes: int = 256 << 20,
                        sock_dir: str | None = None) -> ProcessFleet:
    """Assemble the socket fleet: N spawned children + supervisor.

    The per-child ServeConfig is the supervisor's with telemetry and
    demand stripped (children must not race each other's output files;
    the fleet-level snapshotter nests their stats instead) and the
    transport knobs read off ``config`` (``transport_compress``,
    ``transport_shm``, ``transport_inline_max``).
    """
    from ..serving import ServeConfig
    if config is None:
        config = ServeConfig(overlap_install=False)
    child_cfg = dataclasses.replace(config, telemetry=None, demand=None)
    own_sock_dir = sock_dir is None
    if sock_dir is None:
        sock_dir = tempfile.mkdtemp(prefix="rpt-")
    node_ids = tuple(f"node-{i}" for i in range(n_nodes))
    ctx = mp.get_context("spawn")
    nodes = []
    for node_id in node_ids:
        spec = NodeSpec(
            node_id=node_id, store_dir=store_dir, sock_dir=sock_dir,
            node_ids=node_ids, config=child_cfg,
            replication=replication, vnodes=vnodes,
            cache_capacity_bytes=cache_capacity_bytes,
            transport_compress=getattr(config, "transport_compress", False),
            transport_shm=getattr(config, "transport_shm", True),
            transport_inline_max=getattr(config, "transport_inline_max",
                                         64 << 10))
        nodes.append(ProcessNode(spec, ctx))
    fleet = ProcessFleet(nodes, cfg=cfg, replication=replication,
                         vnodes=vnodes,
                         sock_dir=sock_dir if own_sock_dir else None)
    tcfg = getattr(config, "telemetry", None)
    if tcfg is not None:
        from ..telemetry import TELEMETRY, StatsSnapshotter
        path = (os.path.join(tcfg.out_dir, "fleet.jsonl")
                if tcfg.out_dir else None)
        snap = StatsSnapshotter(interval_s=tcfg.interval_s, path=path,
                                ring=tcfg.ring)
        snap.add_source("cluster", fleet.stats)
        snap.add_source("registry", TELEMETRY.collect)
        fleet.telemetry = snap.start()
    return fleet
