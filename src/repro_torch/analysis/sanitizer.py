"""Opt-in runtime lock sanitizer (``REPRO_LOCK_SANITIZER=1``).

``enable()`` monkeypatches ``threading.Lock``/``RLock``/``Condition`` with
factories that hand back sanitized wrappers *only* when the caller's module
is part of the ``repro_torch`` package (looked up from the calling frame),
so pytest internals, torch, and the stdlib keep the real primitives.

Each wrapper records, per thread, the stack of currently-held locks.  On
every acquisition that happens while other locks are held, the sanitizer
inserts site-order edges ``held -> acquired`` into a global order graph and
runs an incremental cycle check: the first edge that closes a cycle raises
(or records, in deferred mode) a :class:`LockOrderViolation` carrying a
witness trace — both conflicting acquisition stacks with file:line sites.

``Condition.wait`` and a patched ``time.sleep`` additionally detect
*held-across-blocking*: blocking while holding any sanitized lock other
than the one the condition itself releases.

Locks are identified by their **creation site** (``file:line``), not object
identity, so the graph stays small and stable across instances — two
``FunctionRecord.lock`` conditions created at the same line are one node,
which is exactly the granularity the static pass reasons at.
"""
from __future__ import annotations

import os
import sys
import threading
import time
import traceback


_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition
_REAL_SLEEP = time.sleep


class LockOrderViolation(RuntimeError):
    pass


class HeldAcrossBlocking(RuntimeError):
    pass


def _creation_site(depth: int = 1) -> str:
    """file:line of the frame ``depth`` levels above the caller."""
    f = sys._getframe(depth + 1)
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _caller_module(depth: int = 1) -> str:
    try:
        return sys._getframe(depth + 1).f_globals.get("__name__", "")
    except ValueError:
        return ""


class SanitizerState:
    """All sanitizer bookkeeping.  Tests construct private instances; the
    process-wide singleton is :data:`STATE`."""

    def __init__(self, raise_on_violation: bool = True) -> None:
        self._mu = _REAL_LOCK()
        self.raise_on_violation = raise_on_violation
        # site -> set of successor sites, with a witness per edge
        self.edges: dict[str, set[str]] = {}
        self.edge_witness: dict[tuple[str, str], str] = {}
        self.violations: list[dict] = []
        self._tls = threading.local()

    # -- per-thread held stack -------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    def held_sites(self) -> list[str]:
        return [site for site, _n in self._stack()]

    # -- graph ------------------------------------------------------------

    def _find_path(self, src: str, dst: str) -> list[str] | None:
        """DFS path src -> dst in the edge graph (for witness rendering)."""
        seen = {src}
        stack = [(src, [src])]
        while stack:
            node, path = stack.pop()
            for nxt in self.edges.get(node, ()):
                if nxt == dst:
                    return path + [dst]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def record_acquire(self, site: str) -> None:
        stack = self._stack()
        new_witness = "".join(traceback.format_stack(limit=12)[:-2])
        for held_site, _n in stack:
            if held_site == site:
                continue
            with self._mu:
                back = self._find_path(site, held_site)
                self.edges.setdefault(held_site, set()).add(site)
                key = (held_site, site)
                self.edge_witness.setdefault(key, new_witness)
                if back is not None:
                    cycle = [held_site] + back
                    prior = self.edge_witness.get(
                        (back[0], back[1]) if len(back) > 1 else key, "")
                    v = {
                        "kind": "lock-order-cycle",
                        "cycle": cycle,
                        "thread": threading.current_thread().name,
                        "witness_new": new_witness,
                        "witness_prior": prior,
                    }
                    self.violations.append(v)
                    if self.raise_on_violation:
                        raise LockOrderViolation(render_violation(v))
        stack.append((site, 1))

    def record_release(self, site: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == site:
                del stack[i]
                return

    def check_blocking(self, what: str, exempt_site: str | None = None) -> None:
        held = [s for s in self.held_sites() if s != exempt_site]
        if not held:
            return
        v = {
            "kind": "held-across-blocking",
            "blocking": what,
            "held": held,
            "thread": threading.current_thread().name,
            "witness_new": "".join(traceback.format_stack(limit=12)[:-2]),
            "witness_prior": "",
        }
        with self._mu:
            self.violations.append(v)
        if self.raise_on_violation:
            raise HeldAcrossBlocking(render_violation(v))

    def reset(self) -> None:
        with self._mu:
            self.edges.clear()
            self.edge_witness.clear()
            self.violations.clear()


def render_violation(v: dict) -> str:
    lines = [f"[lock-sanitizer] {v['kind']} on thread {v['thread']}"]
    if v["kind"] == "lock-order-cycle":
        lines.append("  cycle: " + " -> ".join(v["cycle"]))
    else:
        lines.append(f"  blocking op: {v['blocking']}")
        lines.append("  held locks: " + ", ".join(v["held"]))
    if v.get("witness_new"):
        lines.append("  acquisition trace:")
        lines.extend("    " + ln for ln in v["witness_new"].rstrip().splitlines())
    if v.get("witness_prior"):
        lines.append("  prior conflicting trace:")
        lines.extend("    " + ln for ln in v["witness_prior"].rstrip().splitlines())
    return "\n".join(lines)


STATE = SanitizerState()


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------

class SanitizedLock:
    _reentrant = False

    def __init__(self, state: SanitizerState | None = None,
                 site: str | None = None) -> None:
        self._state = state or STATE
        self._site = site or _creation_site()
        self._inner = _REAL_RLOCK() if self._reentrant else _REAL_LOCK()
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if self._depth() == 0:
                try:
                    self._state.record_acquire(self._site)
                except BaseException:
                    self._inner.release()
                    raise
            self._tls.depth = self._depth() + 1
        return ok

    def release(self) -> None:
        d = self._depth()
        self._inner.release()
        if d == 1:
            self._state.record_release(self._site)
        self._tls.depth = max(0, d - 1)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._depth() > 0 or (not self._reentrant and self._inner.locked())

    # Condition() introspects these on the lock it's handed
    def _release_save(self):
        d = self._depth()
        self._tls.depth = 0
        if d:
            self._state.record_release(self._site)
        if self._reentrant:
            saved = self._inner._release_save()
            return (saved, d)
        self._inner.release()
        return (None, d)

    def _acquire_restore(self, saved) -> None:
        inner_saved, d = saved
        if self._reentrant:
            self._inner._acquire_restore(inner_saved)
        else:
            self._inner.acquire()
        if d:
            self._state.record_acquire(self._site)
        self._tls.depth = d

    def _is_owned(self) -> bool:
        return self._depth() > 0


class SanitizedRLock(SanitizedLock):
    _reentrant = True


class SanitizedCondition:
    def __init__(self, lock=None, state: SanitizerState | None = None,
                 site: str | None = None) -> None:
        self._state = state or STATE
        self._site = site or _creation_site()
        if lock is None:
            lock = SanitizedRLock(state=self._state, site=self._site)
        self._lock = lock
        self._inner = _REAL_CONDITION(lock)

    @property
    def _sanitized_site(self) -> str:
        return getattr(self._lock, "_site", self._site)

    def acquire(self, *a, **kw):
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        self._state.check_blocking(
            f"Condition.wait at {self._site}", exempt_site=self._sanitized_site)
        return self._inner.wait(timeout)

    def wait_for(self, predicate, timeout: float | None = None):
        self._state.check_blocking(
            f"Condition.wait_for at {self._site}", exempt_site=self._sanitized_site)
        return self._inner.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# --------------------------------------------------------------------------
# Enable / disable
# --------------------------------------------------------------------------

_enabled = False


def _should_sanitize() -> bool:
    # frame 0=_caller_module, 1=_should_sanitize, 2=factory, 3=call site
    mod = _caller_module(2)
    return mod == "repro_torch" or mod.startswith("repro_torch.")


def _lock_factory():
    if _should_sanitize():
        return SanitizedLock(site=_creation_site())
    return _REAL_LOCK()


def _rlock_factory():
    if _should_sanitize():
        return SanitizedRLock(site=_creation_site())
    return _REAL_RLOCK()


def _condition_factory(lock=None):
    if _should_sanitize():
        return SanitizedCondition(lock, site=_creation_site())
    return _REAL_CONDITION(lock)


def _sanitized_sleep(seconds: float) -> None:
    if STATE.held_sites():
        STATE.check_blocking(f"time.sleep({seconds!r})")
    _REAL_SLEEP(seconds)


def enable() -> None:
    """Install the sanitized primitives (idempotent).  Only ``repro_torch.*``
    call sites get wrapped; everyone else sees the real classes."""
    global _enabled
    if _enabled:
        return
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    time.sleep = _sanitized_sleep
    _enabled = True


def disable() -> None:
    global _enabled
    if not _enabled:
        return
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    time.sleep = _REAL_SLEEP
    _enabled = False


def enabled() -> bool:
    return _enabled


def enabled_by_env() -> bool:
    return os.environ.get("REPRO_LOCK_SANITIZER", "") not in ("", "0")
