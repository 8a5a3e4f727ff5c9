"""Repo-specific static analysis + runtime lock sanitizer, for the port.
A copy of the JAX package's ``repro.analysis`` (its passes are
framework-neutral), with the sanitizer scoped to ``repro_torch``.

Static passes (pure stdlib):

- :func:`analyze_lockgraph` — lock discovery, acquisition-order edges from
  ``with`` nesting + call-graph propagation, lock-order cycle and
  blocking-while-locked reporting.
- :func:`analyze_lint` — REP001–REP005 repo-invariant rules.

Runtime sanitizer (``REPRO_LOCK_SANITIZER=1``): :mod:`.sanitizer` wraps
``threading.Lock/RLock/Condition`` for ``repro_torch.*`` call sites and detects
real acquisition-order cycles and held-across-blocking at test time.

The port's accepted findings are listed, each with its reason, in
``tests/test_torch_cluster.py`` (``ACCEPTED``).
"""
from .findings import Finding, dedup
from .lint import analyze_lint
from .lockgraph import analyze_lockgraph

__all__ = [
    "Finding",
    "dedup",
    "analyze_lint",
    "analyze_lockgraph",
    "run_all",
]


def run_all(root: str) -> list[Finding]:
    """Both static passes over ``root``, deduped and stably ordered."""
    return dedup(analyze_lockgraph(root) + analyze_lint(root))
