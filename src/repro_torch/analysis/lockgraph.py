"""Lock-order and blocking-while-locked static analysis.

Walks every module under a package root (normally ``src/repro_torch``) and:

1. **Discovers locks** — ``self.attr = threading.Lock()/RLock()/Condition()``
   assignments inside class bodies and module-level ``NAME = threading.Lock()``
   assignments.  ``threading.Condition(self._lock)`` aliases the condition
   attribute to the underlying lock's identity, so re-entry through either
   name is not a self-edge.
2. **Summarises each function** — a lexical walk tracks the set of held
   locks through ``with`` nesting and records three kinds of events:
   lock *acquisitions* (producing order edges ``held -> acquired``),
   *blocking operations* (``time.sleep``, file/page I/O, ``Future.result``,
   ``cv.wait`` on a lock other than every currently-held one,
   ``WSCache.fetch``, thread-pool ``with``-exit joins), and *calls* into
   other functions of the package.
3. **Propagates summaries over call edges** — a fixpoint computes, for each
   function, the transitive set of locks it may acquire and blocking ops it
   may perform, so ``with rec.lock: self._force_reclaim(...)`` sees the
   ``Future.result`` buried two calls down.
4. **Reports** — ``LOCK-ORDER`` findings for cycles in the acquisition-order
   graph (Tarjan SCC over the union of all order edges) and
   ``LOCK-BLOCKING`` findings for blocking ops reachable while at least one
   non-exempt lock is held.

The pass is deliberately heuristic (no type checker): receivers resolve via
parameter annotations, ``self.attr = ClassName(...)`` constructor
inference, ``dict[str, T]`` element types, and a small local-variable
type environment.  Unresolvable receivers are skipped rather than guessed,
so findings err toward precision; the seeded-violation fixtures in
``tests/`` pin the recall we rely on.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Optional, Union

from .findings import Finding, dedup

LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore"}

# Dotted-path calls that always block.
BLOCKING_DOTTED = {
    "time.sleep": "time.sleep",
    "os.preadv": "file I/O (os.preadv)",
    "os.pread": "file I/O (os.pread)",
    "os.read": "file I/O (os.read)",
    "os.fsync": "file I/O (os.fsync)",
    "np.load": "file I/O (np.load)",
    "numpy.load": "file I/O (np.load)",
    "np.save": "file I/O (np.save)",
    "numpy.save": "file I/O (np.save)",
}
# Bare-name calls that always block.
BLOCKING_NAMES = {
    "open": "file I/O (open)",
    "connect_handshake": "connection handshake",
}
# Method names (last dotted segment) that block regardless of receiver.
BLOCKING_METHODS = {
    "result": "Future.result",
    "read_page": "page-source I/O",
    "read_span": "page-source I/O",
    "fetch": "single-flight fetch",
    "acquire_throttled": "throttled acquire",
}
WAIT_METHODS = {"wait", "wait_for"}


# --------------------------------------------------------------------------
# Discovery data model
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClassInfo:
    name: str
    module: str            # repo-relative path
    bases: list[str]
    methods: dict[str, ast.FunctionDef] = dataclasses.field(default_factory=dict)
    # attr -> lock id (aliases resolved), e.g. {"_lock": "InstanceArena._lock"}
    lock_attrs: dict[str, str] = dataclasses.field(default_factory=dict)
    # attr -> inferred type: "ClassName" | ("dict", "V") | ("list", "V")
    attr_types: dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class FuncInfo:
    key: str               # "Class.method" or "module.py:func"
    module: str
    node: ast.FunctionDef
    cls: Optional[ClassInfo]
    # local events (populated by the summary walk)
    acquires: list = dataclasses.field(default_factory=list)   # (lock, held, line)
    blocking: list = dataclasses.field(default_factory=list)   # (kind, held, exempt, line)
    calls: list = dataclasses.field(default_factory=list)      # (callee_key, held, line)
    # transitive closures (fixpoint)
    acq_closure: set = dataclasses.field(default_factory=set)      # lock ids
    blk_closure: set = dataclasses.field(default_factory=set)      # (kind, origin_key, exempt)


class Registry:
    def __init__(self) -> None:
        self.classes: dict[str, ClassInfo] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self.module_locks: dict[str, str] = {}      # "path:NAME" -> lock id
        self.lock_kinds: dict[str, str] = {}        # lock id -> factory name
        # attr name -> lock ids sharing it (for unique-attr fallback)
        self.attr_index: dict[str, set[str]] = {}
        self.imports: dict[str, dict[str, str]] = {}  # module -> local name -> symbol

    def method_of(self, cls: ClassInfo, name: str) -> Optional[FuncInfo]:
        seen = set()
        cur: Optional[ClassInfo] = cls
        while cur and cur.name not in seen:
            seen.add(cur.name)
            fi = self.funcs.get(f"{cur.name}.{name}")
            if fi is not None:
                return fi
            cur = next((self.classes[b] for b in cur.bases if b in self.classes), None)
        return None

    def lock_attr_of(self, cls: ClassInfo, attr: str) -> Optional[str]:
        seen = set()
        cur: Optional[ClassInfo] = cls
        while cur and cur.name not in seen:
            seen.add(cur.name)
            if attr in cur.lock_attrs:
                return cur.lock_attrs[attr]
            cur = next((self.classes[b] for b in cur.bases if b in self.classes), None)
        return None

    def attr_type_of(self, cls: ClassInfo, attr: str):
        seen = set()
        cur: Optional[ClassInfo] = cls
        while cur and cur.name not in seen:
            seen.add(cur.name)
            if attr in cur.attr_types:
                return cur.attr_types[attr]
            cur = next((self.classes[b] for b in cur.bases if b in self.classes), None)
        return None


# --------------------------------------------------------------------------
# Small AST helpers
# --------------------------------------------------------------------------

def _dotted(node: ast.expr) -> Optional[str]:
    """'time.sleep' for Attribute chains, 'open' for Name, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_threading_factory(call: ast.Call) -> Optional[str]:
    path = _dotted(call.func)
    if path is None:
        return None
    last = path.rsplit(".", 1)[-1]
    if last in LOCK_FACTORIES and (path == last or path.startswith("threading.")):
        return last
    return None


def _ann_type(ann: Optional[ast.expr]):
    """Annotation -> 'ClassName' | ('dict', V) | ('list', V) | None."""
    if ann is None:
        return None
    if isinstance(ann, ast.Name):
        return ann.id
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.split("[")[0].split(".")[-1] or None
    if isinstance(ann, ast.Attribute):
        return ann.attr
    if isinstance(ann, ast.Subscript):
        base = _ann_type(ann.value)
        if base in ("dict", "Dict"):
            elts = ann.slice.elts if isinstance(ann.slice, ast.Tuple) else [ann.slice]
            if len(elts) == 2:
                return ("dict", _ann_type(elts[1]))
        if base in ("list", "List", "set", "Set", "deque", "Optional", "Sequence",
                    "Iterable", "Iterator"):
            inner = ann.slice.elts[0] if isinstance(ann.slice, ast.Tuple) else ann.slice
            if base == "Optional":
                return _ann_type(inner)
            return ("list", _ann_type(inner))
    return None


def _elem(t):
    return t[1] if isinstance(t, tuple) else None


# --------------------------------------------------------------------------
# Pass 1: discovery
# --------------------------------------------------------------------------

def _discover(tree: ast.Module, path: str, reg: Registry) -> None:
    imports: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                imports[alias.asname or alias.name] = alias.name
    reg.imports[path] = imports

    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr", "")
                     for b in node.bases]
            ci = ClassInfo(node.name, path, bases)
            reg.classes[node.name] = ci
            for item in node.body:
                if isinstance(item, ast.FunctionDef):
                    ci.methods[item.name] = item
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            kind = _is_threading_factory(node.value)
            if kind and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                lock_id = f"{path}:{name}"
                reg.module_locks[lock_id] = lock_id
                reg.lock_kinds[lock_id] = kind
                reg.attr_index.setdefault(name, set()).add(lock_id)

    # second sweep: per-class attr discovery needs the full class table
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        ci = reg.classes[node.name]
        # dataclass-style annotated fields contribute attr types
        for item in node.body:
            if isinstance(item, ast.AnnAssign) and isinstance(item.target, ast.Name):
                t = _ann_type(item.annotation)
                if t:
                    ci.attr_types[item.target.id] = t
        for meth in ci.methods.values():
            for stmt in ast.walk(meth):
                tgt = None
                val = None
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                    tgt, val = stmt.targets[0], stmt.value
                elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    tgt, val = stmt.target, stmt.value
                    if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"):
                        t = _ann_type(stmt.annotation)
                        if t:
                            ci.attr_types.setdefault(tgt.attr, t)
                if not (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self" and isinstance(val, ast.Call)):
                    continue
                attr = tgt.attr
                kind = _is_threading_factory(val)
                if kind == "Condition" and val.args:
                    # Condition(self._x): alias to the underlying lock
                    under = val.args[0]
                    if (isinstance(under, ast.Attribute)
                            and isinstance(under.value, ast.Name)
                            and under.value.id == "self"):
                        target_id = ci.lock_attrs.get(
                            under.attr, f"{ci.name}.{under.attr}")
                        ci.lock_attrs[attr] = target_id
                        reg.attr_index.setdefault(attr, set()).add(target_id)
                        continue
                if kind:
                    lock_id = f"{ci.name}.{attr}"
                    ci.lock_attrs.setdefault(attr, lock_id)
                    reg.lock_kinds[lock_id] = kind
                    reg.attr_index.setdefault(attr, set()).add(lock_id)
                    continue
                ctor = _dotted(val.func)
                if ctor:
                    last = ctor.rsplit(".", 1)[-1]
                    ci.attr_types.setdefault(attr, last)


# --------------------------------------------------------------------------
# Pass 2: per-function summaries
# --------------------------------------------------------------------------

class _FuncWalker:
    def __init__(self, reg: Registry, fi: FuncInfo) -> None:
        self.reg = reg
        self.fi = fi
        self.env: dict[str, object] = {}
        args = fi.node.args
        for a in (args.posonlyargs + args.args + args.kwonlyargs):
            t = _ann_type(a.annotation)
            if t:
                self.env[a.arg] = t

    # -- type / lock resolution ------------------------------------------

    def resolve_type(self, node: ast.expr):
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            base = self.resolve_type(node.value)
            if isinstance(node.value, ast.Name) and node.value.id == "self" and self.fi.cls:
                return self.reg.attr_type_of(self.fi.cls, node.attr)
            if isinstance(base, str) and base in self.reg.classes:
                return self.reg.attr_type_of(self.reg.classes[base], node.attr)
            return None
        if isinstance(node, ast.Subscript):
            return _elem(self.resolve_type(node.value))
        if isinstance(node, ast.Call):
            path = _dotted(node.func)
            if path:
                last = path.rsplit(".", 1)[-1]
                if last in self.reg.classes and (path == last or "." not in path):
                    return last
                if last == "list" and node.args:
                    t = self.resolve_type(node.args[0])
                    return t if isinstance(t, tuple) else ("list", t)
                if last in ("values", "get", "pop", "popleft", "popitem", "setdefault"):
                    recv = node.func.value if isinstance(node.func, ast.Attribute) else None
                    if recv is not None:
                        rt = self.resolve_type(recv)
                        e = _elem(rt)
                        if last == "values":
                            return ("list", e)
                        return e
            return None
        return None

    def resolve_lock(self, node: ast.expr) -> Optional[str]:
        """Resolve an expression to a lock identity, or None."""
        if isinstance(node, ast.Attribute):
            recv = node.value
            if isinstance(recv, ast.Name) and recv.id == "self" and self.fi.cls:
                return self.reg.lock_attr_of(self.fi.cls, node.attr)
            rt = self.resolve_type(recv)
            if isinstance(rt, str) and rt in self.reg.classes:
                return self.reg.lock_attr_of(self.reg.classes[rt], node.attr)
            # unique-attr fallback: exactly one lock in the package has
            # this attribute name
            ids = self.reg.attr_index.get(node.attr, set())
            if len(ids) == 1:
                return next(iter(ids))
            return None
        if isinstance(node, ast.Name):
            ids = {lid for lid in self.reg.module_locks
                   if lid.endswith(f":{node.id}")}
            own = f"{self.fi.module}:{node.id}"
            if own in ids:
                return own
            if len(ids) == 1:
                return next(iter(ids))
            if node.id in self.env:
                t = self.env[node.id]
                if isinstance(t, str) and t in self.reg.lock_kinds:
                    return t
        return None

    # -- call resolution --------------------------------------------------

    def resolve_call(self, call: ast.Call) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Attribute):
            recv = func.value
            if isinstance(recv, ast.Name) and recv.id == "self" and self.fi.cls:
                m = self.reg.method_of(self.fi.cls, func.attr)
                return m.key if m else None
            rt = self.resolve_type(recv)
            if isinstance(rt, str) and rt in self.reg.classes:
                m = self.reg.method_of(self.reg.classes[rt], func.attr)
                return m.key if m else None
            return None
        if isinstance(func, ast.Name):
            name = func.id
            if name in self.reg.classes:
                m = self.reg.method_of(self.reg.classes[name], "__init__")
                return m.key if m else None
            key = f"{self.fi.module}:{name}"
            if key in self.reg.funcs:
                return key
            target = self.reg.imports.get(self.fi.module, {}).get(name)
            if target:
                for k in self.reg.funcs:
                    if k.endswith(f":{target}"):
                        return k
                if target in self.reg.classes:
                    m = self.reg.method_of(self.reg.classes[target], "__init__")
                    return m.key if m else None
        return None

    # -- the walk ---------------------------------------------------------

    def walk(self) -> None:
        for stmt in self.fi.node.body:
            self._visit(stmt, ())

    def _visit(self, node: ast.AST, held: tuple) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                             ast.ClassDef)):
            return  # nested scopes get their own (unresolved) summaries
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            self._infer_assign(node)
        if isinstance(node, ast.For):
            t = self.resolve_type(node.iter)
            if isinstance(node.target, ast.Name) and _elem(t):
                self.env[node.target.id] = _elem(t)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = list(held)
            for item in node.items:
                ctx = item.context_expr
                lock = None
                if isinstance(ctx, ast.Call):
                    path = _dotted(ctx.func) or ""
                    last = path.rsplit(".", 1)[-1]
                    if last == "ThreadPoolExecutor":
                        # with-exit joins the workers: blocking
                        self.fi.blocking.append(
                            ("thread-pool join at with-exit", tuple(new_held),
                             frozenset(), ctx.lineno))
                    self._visit(ctx, tuple(new_held))
                else:
                    lock = self.resolve_lock(ctx)
                if lock is not None and lock not in new_held:
                    self.fi.acquires.append((lock, tuple(new_held), ctx.lineno))
                    new_held.append(lock)
                if item.optional_vars is not None and lock is None \
                        and isinstance(item.optional_vars, ast.Name):
                    t = self.resolve_type(ctx)
                    if t:
                        self.env[item.optional_vars.id] = t
            for stmt in node.body:
                self._visit(stmt, tuple(new_held))
            return
        if isinstance(node, ast.Call):
            self._visit_call(node, held)
            for child in ast.iter_child_nodes(node):
                self._visit(child, held)
            return
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)

    def _infer_assign(self, node: Union[ast.Assign, ast.AnnAssign]) -> None:
        tgt = node.targets[0] if isinstance(node, ast.Assign) else node.target
        if not isinstance(tgt, ast.Name):
            return
        t = None
        if isinstance(node, ast.AnnAssign):
            t = _ann_type(node.annotation)
        if t is None and node.value is not None:
            t = self.resolve_type(node.value)
        if t:
            self.env[tgt.id] = t

    def _visit_call(self, call: ast.Call, held: tuple) -> None:
        path = _dotted(call.func)
        if path is None:
            return
        last = path.rsplit(".", 1)[-1]

        if path in BLOCKING_DOTTED:
            self.fi.blocking.append(
                (BLOCKING_DOTTED[path], held, frozenset(), call.lineno))
            return
        if path in BLOCKING_NAMES:
            self.fi.blocking.append(
                (BLOCKING_NAMES[path], held, frozenset(), call.lineno))
            return
        if last in WAIT_METHODS and isinstance(call.func, ast.Attribute):
            lock = self.resolve_lock(call.func.value)
            if lock is not None:
                # waiting on a condition releases *its own* lock only
                self.fi.blocking.append(
                    (f"cv.wait on {lock}", held, frozenset({lock}), call.lineno))
            return
        if last in BLOCKING_METHODS and isinstance(call.func, ast.Attribute):
            # skip str.join-style literals
            if not isinstance(call.func.value, ast.Constant):
                self.fi.blocking.append(
                    (BLOCKING_METHODS[last], held, frozenset(), call.lineno))
            return

        callee = self.resolve_call(call)
        if callee is not None and callee != self.fi.key:
            self.fi.calls.append((callee, held, call.lineno))


# --------------------------------------------------------------------------
# Pass 2.5: cross-class attribute-type fixpoint
# --------------------------------------------------------------------------

def _infer_attr_types(reg: Registry) -> None:
    """Propagate attr types through assignments like
    ``self._tail = pipe.tail`` (param-annotation + other classes' attr
    types), iterated to fixpoint so discovery order doesn't matter."""
    method_fis = [fi for fi in reg.funcs.values() if fi.cls is not None]
    for _round in range(5):
        changed = False
        for fi in method_fis:
            w = _FuncWalker(reg, fi)
            for stmt in ast.walk(fi.node):
                if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1):
                    continue
                tgt = stmt.targets[0]
                if not (isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"):
                    continue
                if tgt.attr in fi.cls.attr_types or tgt.attr in fi.cls.lock_attrs:
                    continue
                t = w.resolve_type(stmt.value)
                if t:
                    fi.cls.attr_types[tgt.attr] = t
                    changed = True
        if not changed:
            break


# --------------------------------------------------------------------------
# Pass 3: fixpoint over call edges
# --------------------------------------------------------------------------

def _fixpoint(reg: Registry) -> None:
    for fi in reg.funcs.values():
        fi.acq_closure = {lock for lock, _held, _ln in fi.acquires}
        fi.blk_closure = {(kind, fi.key, exempt)
                          for kind, _held, exempt, _ln in fi.blocking}
    changed = True
    while changed:
        changed = False
        for fi in reg.funcs.values():
            for callee_key, _held, _ln in fi.calls:
                callee = reg.funcs.get(callee_key)
                if callee is None:
                    continue
                if not callee.acq_closure <= fi.acq_closure:
                    fi.acq_closure |= callee.acq_closure
                    changed = True
                if not callee.blk_closure <= fi.blk_closure:
                    fi.blk_closure |= callee.blk_closure
                    changed = True


# --------------------------------------------------------------------------
# Pass 4: findings
# --------------------------------------------------------------------------

def _tarjan_sccs(nodes: set, edges: dict) -> list:
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]

    def strongconnect(v):
        work = [(v, iter(sorted(edges.get(v, ()))))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(sorted(edges.get(w, ())))))
                    advanced = True
                    break
                elif w in on_stack:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(nodes):
        if v not in index:
            strongconnect(v)
    return sccs


def analyze_lockgraph(root: str) -> list[Finding]:
    """Run the full pass over ``root`` (a package directory) and return
    LOCK-ORDER / LOCK-BLOCKING findings."""
    reg = Registry()
    modules: dict[str, ast.Module] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            try:
                with open(full, "r", encoding="utf-8") as fh:
                    modules[rel] = ast.parse(fh.read(), filename=rel)
            except SyntaxError:
                continue

    for rel, tree in modules.items():
        _discover(tree, rel, reg)

    # function table
    for rel, tree in modules.items():
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                key = f"{rel}:{node.name}"
                reg.funcs[key] = FuncInfo(key, rel, node, None)
    for ci in reg.classes.values():
        for name, node in ci.methods.items():
            key = f"{ci.name}.{name}"
            reg.funcs[key] = FuncInfo(key, ci.module, node, ci)

    _infer_attr_types(reg)

    for fi in reg.funcs.values():
        _FuncWalker(reg, fi).walk()

    _fixpoint(reg)

    findings: list[Finding] = []

    # ---- order edges + held-across-blocking, local and via calls --------
    edges: dict = {}
    witness: dict = {}  # (a, b) -> (module, line, func_key)

    def add_edge(a, b, module, line, func_key):
        if a == b:
            return
        edges.setdefault(a, set()).add(b)
        witness.setdefault((a, b), (module, line, func_key))

    for fi in reg.funcs.values():
        for lock, held, line in fi.acquires:
            for h in held:
                add_edge(h, lock, fi.module, line, fi.key)
        for callee_key, held, line in fi.calls:
            if not held:
                continue
            callee = reg.funcs.get(callee_key)
            if callee is None:
                continue
            for lock in callee.acq_closure:
                for h in held:
                    add_edge(h, lock, fi.module, line, fi.key)
            for kind, origin, exempt in callee.blk_closure:
                bad = [h for h in held if h not in exempt]
                if bad:
                    via = f" via {origin}" if origin != fi.key else ""
                    findings.append(Finding(
                        rule="LOCK-BLOCKING", path=fi.module, line=line,
                        symbol=fi.key,
                        message=(f"{kind}{via} while holding "
                                 f"{', '.join(sorted(bad))}"),
                        detail=f"{kind}|{origin}|{'+'.join(sorted(bad))}"))
        for kind, held, exempt, line in fi.blocking:
            bad = [h for h in held if h not in exempt]
            if bad:
                findings.append(Finding(
                    rule="LOCK-BLOCKING", path=fi.module, line=line,
                    symbol=fi.key,
                    message=f"{kind} while holding {', '.join(sorted(bad))}",
                    detail=f"{kind}|{fi.key}|{'+'.join(sorted(bad))}"))

    # ---- cycles ---------------------------------------------------------
    nodes = set(edges) | {b for bs in edges.values() for b in bs}
    for scc in _tarjan_sccs(nodes, edges):
        cyclic = len(scc) > 1 or (len(scc) == 1 and scc[0] in edges.get(scc[0], ()))
        if not cyclic:
            continue
        cyc = sorted(scc)
        sites = []
        for a in cyc:
            for b in cyc:
                w = witness.get((a, b))
                if w:
                    sites.append(f"{a}->{b} at {w[0]}:{w[1]} ({w[2]})")
        mod, line, func = witness.get(
            (cyc[0], cyc[1] if len(cyc) > 1 else cyc[0]),
            (next(iter(sites), "?:0 (?)").split(" at ")[-1].split(":")[0], 0, "?")
        )[:3] if witness else ("?", 0, "?")
        findings.append(Finding(
            rule="LOCK-ORDER", path=mod, line=line, symbol=func,
            message=("lock-order cycle: " + " <-> ".join(cyc)
                     + "; witnesses: " + "; ".join(sites)),
            detail="+".join(cyc)))

    return dedup(findings)
