"""Repo-invariant lint rules (REP001–REP008).

These encode invariants the codebase already depends on but nothing
enforced until now:

REP001  clock-injectable modules (``serving/``, ``cluster/``,
        ``core/restore.py``) must not *call* ``time.time`` /
        ``time.monotonic`` / ``time.perf_counter`` / ``time.sleep`` in a
        function body.  The injected-clock seam — ``clock=time.monotonic``
        as a default parameter value — is an ``ast.Attribute`` reference,
        not a Call, and stays legal.
REP002  instance state transitions go through the state-machine methods:
        raw ``<obj>.state = State.X`` writes are only legal inside
        ``FunctionInstance``'s own transition methods.
REP003  the process-wide ``WS_CACHE`` is touched only through its
        single-flight API: no private-attribute reads/writes from outside
        ``core/reap.py``.
REP004  every module that spawns a ``threading.Thread`` must contain a
        reachable ``.join(`` call, and a ``ThreadPoolExecutor`` created
        outside a ``with`` block requires a ``.shutdown(`` call somewhere
        in the module.
REP005  the seven ``StageTimings`` stage fields are written only through a
        ``timings``/``stages`` receiver (PR 6's source-of-truth contract);
        flat writes like ``report.install_s = ...`` are flagged.
REP006  telemetry emission goes through ``MetricsRegistry``: a *new*
        ``stats()``-style method building an ad-hoc stats dict in the
        clock-injectable scope (``serving/``, ``cluster/``,
        ``core/restore.py``) is flagged unless it is one of the documented
        snapshotter surfaces (telemetry/schema.py) listed in
        ``REP006_STATS_SURFACES``.
REP007  WS bytes are content-addressed: the ``.ws`` file may be a chunk
        manifest, so *reading* it as raw bytes (``open``/``os.open``/
        ``PageSource``/``np.memmap``/``np.fromfile`` over a ``ws_path()``
        argument) is only legal inside ``core/pagestore.py`` and the
        legacy flat-format seam (``core/reap.py::_read_ws_flat``).
        Metadata probes (``getmtime``/``exists``) and write-mode opens
        stay legal everywhere.
REP008  the page data plane lives behind the package's ``transport/``:
        importing ``socket`` or ``multiprocessing.shared_memory``
        anywhere else is flagged.  The rest of the tree talks chunks and
        manifests, never file descriptors — keeping every raw-wire and
        shared-memory touchpoint behind one seam.  (core/restore.py's
        ``connect_handshake`` socketpair loopback predates the transport
        layer and is accepted via the analysis baseline, not a code
        exemption.)
"""
from __future__ import annotations

import ast
import os
from typing import Optional

from .findings import Finding, dedup

TIME_CALLS = {"time", "monotonic", "perf_counter", "sleep",
              "monotonic_ns", "perf_counter_ns", "time_ns"}

REP001_SCOPES = ("serving/", "cluster/")
REP001_FILES = ("core/restore.py",)

STATE_TRANSITION_METHODS = {
    ("FunctionInstance", "__init__"),
    ("FunctionInstance", "_adopt"),
    ("FunctionInstance", "try_acquire"),
    ("FunctionInstance", "release"),
    ("FunctionInstance", "try_reclaim"),
    ("FunctionInstance", "reclaim"),
}

# StageTimings dataclass fields (prefetch_s is a derived property and the
# Monitor keeps a flat legacy copy, so it is deliberately not listed).
STAGE_FIELDS = {"load_vmm_s", "connection_s", "ws_fetch_s", "install_s",
                "materialize_s", "materialize_to_resident_s", "tail_wait_s"}
STAGE_RECEIVERS = {"timings", "stages", "t"}

WS_CACHE_PRIVATE = {"_entries", "_inflight", "_gens", "_order", "_lock",
                    "_bytes", "_listeners"}

# REP006: the documented stats()/snapshotter surfaces (telemetry/schema.py).
# Anything else named like a stats emitter that builds a dict literal in
# the clock-injectable scope should be a MetricsRegistry emission instead.
REP006_STATS_SURFACES = {
    ("serving/router.py", "Router.stats"),
    ("serving/orchestrator.py", "Orchestrator.tail_stats"),
    ("serving/policy.py", "PrewarmPolicy.stats"),
    ("cluster/node.py", "WorkerNode.stats"),
    ("cluster/scheduler.py", "ClusterRouter.stats"),
    ("cluster/demand.py", "DemandAggregator.stats"),
    ("cluster/snapstore.py", "ShardedSnapshotStore.stats"),
}


# REP007: the only places allowed to read WS-record bytes directly.  The
# page store owns the chunk data; _read_ws_flat is the format-versioned
# fallback for legacy flat WS files (and the flat baseline arm).
REP007_ALLOWED_FILES = {"core/pagestore.py"}
REP007_SEAMS = {("core/reap.py", "_read_ws_flat")}
REP007_READER_NAMES = {"PageSource"}
REP007_READER_DOTTED = {("os", "open"), ("np", "memmap"), ("np", "fromfile"),
                        ("numpy", "memmap"), ("numpy", "fromfile")}

# REP008: only the transport package may touch the raw data plane.
REP008_ALLOWED_PREFIX = "transport/"
REP008_MODULES = ("socket", "multiprocessing.shared_memory")


def _stats_like(name: str) -> bool:
    return (name in ("stats", "metrics")
            or name.endswith("_stats") or name.endswith("_metrics"))


def _in_rep001_scope(rel: str) -> bool:
    return rel.startswith(REP001_SCOPES) or rel in REP001_FILES


def _qualname_stack(stack: list) -> str:
    return ".".join(stack) if stack else "<module>"


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str) -> None:
        self.rel = rel
        self.stack: list[str] = []      # enclosing class/function names
        self.findings: list[Finding] = []

    # -- scope bookkeeping -----------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_rep006(node)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- REP008 -----------------------------------------------------------

    def _rep008(self, lineno: int, what: str) -> None:
        self.findings.append(Finding(
            rule="REP008", path=self.rel, line=lineno,
            symbol=_qualname_stack(self.stack),
            message=(f"raw data-plane import ({what}) outside "
                     "transport/; sockets and shared memory are "
                     "confined behind the transport seam"),
            detail=f"data-plane-import:{what}"))

    def visit_Import(self, node: ast.Import) -> None:
        if not self.rel.startswith(REP008_ALLOWED_PREFIX):
            for alias in node.names:
                if (alias.name in REP008_MODULES
                        or alias.name.startswith("socket.")):
                    self._rep008(node.lineno, alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if not self.rel.startswith(REP008_ALLOWED_PREFIX):
            mod = node.module or ""
            if (mod in REP008_MODULES or mod.startswith("socket.")
                    or mod.startswith("multiprocessing.shared_memory.")):
                self._rep008(node.lineno, mod)
            elif mod == "multiprocessing":
                for alias in node.names:
                    if alias.name == "shared_memory":
                        self._rep008(node.lineno,
                                     "multiprocessing.shared_memory")
        self.generic_visit(node)

    # -- REP006 -----------------------------------------------------------

    def _check_rep006(self, node: ast.FunctionDef) -> None:
        """Flag a new stats-emitting method building an ad-hoc dict in the
        clock-injectable scope: telemetry belongs in MetricsRegistry, and
        snapshotter surfaces belong in the documented schema."""
        if not _in_rep001_scope(self.rel) or not _stats_like(node.name):
            return
        qual = ".".join([*self.stack, node.name])
        if (self.rel, qual) in REP006_STATS_SURFACES:
            return
        if not self._builds_stats_dict(node):
            return
        self.findings.append(Finding(
            rule="REP006", path=self.rel, line=node.lineno, symbol=qual,
            message=("new ad-hoc stats dict surface; emit through "
                     "MetricsRegistry (telemetry/) or add the surface "
                     "to the documented snapshotter schema "
                     "(telemetry/schema.py + REP006_STATS_SURFACES)"),
            detail=f"adhoc-stats:{node.name}"))

    @staticmethod
    def _builds_stats_dict(node: ast.FunctionDef) -> bool:
        """True when the function both returns something and contains a
        multi-key dict literal (covers ``return {...}`` and the
        ``out = {...}; ...; return out`` shape alike)."""
        has_return = any(isinstance(n, ast.Return) and n.value is not None
                         for n in ast.walk(node))
        has_dict = any(isinstance(n, ast.Dict) and len(n.keys) >= 2
                       for n in ast.walk(node))
        return has_return and has_dict

    # -- REP001 -----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if (_in_rep001_scope(self.rel)
                and isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "time"
                and f.attr in TIME_CALLS):
            self.findings.append(Finding(
                rule="REP001", path=self.rel, line=node.lineno,
                symbol=_qualname_stack(self.stack),
                message=(f"direct time.{f.attr}() call in a clock-injectable "
                         "module; route through the injected clock/sleep "
                         "parameter instead"),
                detail=f"time.{f.attr}"))
        self._check_rep007(node)
        self.generic_visit(node)

    # -- REP007 -----------------------------------------------------------

    @staticmethod
    def _open_mode(node: ast.Call) -> str:
        if (len(node.args) >= 2 and isinstance(node.args[1], ast.Constant)
                and isinstance(node.args[1].value, str)):
            return node.args[1].value
        for kw in node.keywords:
            if (kw.arg == "mode" and isinstance(kw.value, ast.Constant)
                    and isinstance(kw.value.value, str)):
                return kw.value.value
        return "r"

    @staticmethod
    def _has_ws_path_call(expr: ast.expr) -> bool:
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                g = n.func
                if isinstance(g, ast.Name) and g.id == "ws_path":
                    return True
                if isinstance(g, ast.Attribute) and g.attr == "ws_path":
                    return True
        return False

    def _check_rep007(self, node: ast.Call) -> None:
        """Flag raw byte reads of a ``ws_path()`` file outside the page
        store and the legacy fallback seam."""
        if self.rel in REP007_ALLOWED_FILES:
            return
        fn = self.stack[-1] if self.stack else None
        if (self.rel, fn) in REP007_SEAMS:
            return
        f = node.func
        target = None
        if isinstance(f, ast.Name):
            if f.id == "open":
                mode = self._open_mode(node)
                if any(c in mode for c in "wax"):
                    return               # writers are legal everywhere
                target = "open"
            elif f.id in REP007_READER_NAMES:
                target = f.id
        elif isinstance(f, ast.Attribute):
            if f.attr in REP007_READER_NAMES:
                target = f.attr
            elif (isinstance(f.value, ast.Name)
                    and (f.value.id, f.attr) in REP007_READER_DOTTED):
                target = f"{f.value.id}.{f.attr}"
        if target is None:
            return
        if not any(self._has_ws_path_call(a)
                   for a in [*node.args, *[k.value for k in node.keywords]]):
            return
        self.findings.append(Finding(
            rule="REP007", path=self.rel, line=node.lineno,
            symbol=_qualname_stack(self.stack),
            message=(f"direct WS byte read ({target} over ws_path(...)); "
                     "the .ws file may be a chunk manifest — go through "
                     "core/pagestore.py or the _read_ws_flat legacy seam"),
            detail=f"ws-byte-read:{target}"))

    # -- REP002 / REP005 (attribute writes) -------------------------------

    def visit_Assign(self, node: ast.Assign) -> None:
        for tgt in node.targets:
            self._check_attr_write(tgt, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._check_attr_write(node.target, node.value, node.lineno)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_attr_write(node.target, None, node.lineno)
        self.generic_visit(node)

    def _check_attr_write(self, tgt: ast.expr, value: Optional[ast.expr],
                          lineno: int) -> None:
        if not isinstance(tgt, ast.Attribute):
            return
        # REP002: raw `.state = State.X`
        if tgt.attr == "state" and self._is_state_value(value):
            where = (self.stack[-2] if len(self.stack) >= 2 else None,
                     self.stack[-1] if self.stack else None)
            if where not in STATE_TRANSITION_METHODS:
                self.findings.append(Finding(
                    rule="REP002", path=self.rel, line=lineno,
                    symbol=_qualname_stack(self.stack),
                    message=("raw instance-state write; use the "
                             "state-machine methods (try_acquire/release/"
                             "try_reclaim/reclaim) instead"),
                    detail="raw-state-write"))
        # REP003: assignment onto WS_CACHE attributes
        if isinstance(tgt.value, ast.Name) and tgt.value.id == "WS_CACHE":
            self.findings.append(Finding(
                rule="REP003", path=self.rel, line=lineno,
                symbol=_qualname_stack(self.stack),
                message="direct write to WS_CACHE attribute; use the "
                        "single-flight API",
                detail=f"write:{tgt.attr}"))
        # REP005: flat stage-field writes outside a timings receiver
        if tgt.attr in STAGE_FIELDS and self.rel != "core/reap.py":
            recv = tgt.value
            recv_name = None
            if isinstance(recv, ast.Name):
                recv_name = recv.id
            elif isinstance(recv, ast.Attribute):
                recv_name = recv.attr
            if recv_name not in STAGE_RECEIVERS:
                self.findings.append(Finding(
                    rule="REP005", path=self.rel, line=lineno,
                    symbol=_qualname_stack(self.stack),
                    message=(f"stage timing '{tgt.attr}' written outside "
                             "StageTimings; stage seconds are "
                             "StageTimings-authoritative (PR 6 contract)"),
                    detail=f"flat-write:{tgt.attr}"))

    @staticmethod
    def _is_state_value(value: Optional[ast.expr]) -> bool:
        """True for `State.X` / `<mod>.State.X` values (and unknown for
        AugAssign, which we treat as suspicious only for State attrs)."""
        if value is None:
            return False
        node = value
        while isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) and node.value.id == "State":
                return True
            node = node.value
        return False

    # -- REP003 (reads of private attrs) ----------------------------------

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "WS_CACHE"
                and node.attr.startswith("_")
                and self.rel != "core/reap.py"):
            self.findings.append(Finding(
                rule="REP003", path=self.rel, line=node.lineno,
                symbol=_qualname_stack(self.stack),
                message=(f"WS_CACHE private attribute '{node.attr}' touched "
                         "outside core/reap.py; use the single-flight API"),
                detail=f"read:{node.attr}"))
        self.generic_visit(node)


def _module_rep004(rel: str, tree: ast.Module, src: str) -> list[Finding]:
    """Module-granular thread-lifecycle audit."""
    findings: list[Finding] = []
    spawns_thread: Optional[int] = None
    bare_pool: Optional[int] = None
    with_pool_ctxs: set[int] = set()

    for node in ast.walk(tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call):
                    with_pool_ctxs.add(id(ctx))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        path_parts = []
        f = node.func
        while isinstance(f, ast.Attribute):
            path_parts.append(f.attr)
            f = f.value
        if isinstance(f, ast.Name):
            path_parts.append(f.id)
        name = path_parts[0] if path_parts else ""
        if name == "Thread":
            spawns_thread = spawns_thread or node.lineno
        elif name == "ThreadPoolExecutor" and id(node) not in with_pool_ctxs:
            bare_pool = bare_pool or node.lineno

    has_join = ".join(" in src
    has_shutdown = ".shutdown(" in src or "shutdown(" in src
    if spawns_thread is not None and not has_join:
        findings.append(Finding(
            rule="REP004", path=rel, line=spawns_thread, symbol="<module>",
            message=("module spawns threading.Thread but contains no "
                     ".join() path; every spawned thread needs a reachable "
                     "join/quiesce/cancel"),
            detail="thread-without-join"))
    if bare_pool is not None and not has_shutdown:
        findings.append(Finding(
            rule="REP004", path=rel, line=bare_pool, symbol="<module>",
            message=("ThreadPoolExecutor created outside a with-block and "
                     "the module has no .shutdown() path"),
            detail="pool-without-shutdown"))
    return findings


def analyze_lint(root: str) -> list[Finding]:
    """Run REP001–REP008 over every ``.py`` under ``root``."""
    findings: list[Finding] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            with open(full, "r", encoding="utf-8") as fh:
                src = fh.read()
            try:
                tree = ast.parse(src, filename=rel)
            except SyntaxError:
                continue
            linter = _Linter(rel)
            linter.visit(tree)
            findings.extend(linter.findings)
            findings.extend(_module_rep004(rel, tree, src))
    return dedup(findings)
