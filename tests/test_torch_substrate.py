"""The port's snapshot substrate against the JAX package's, byte for byte.

Snapshot files (``.mem`` + ``.manifest.json``) of every dense SMOKE config,
REAPWS2 working-set records and the content-addressed page store read
across packages, and the port's independence from JAX: it imports with
``jax`` and ``repro`` blocked and names neither in its sources.
"""
import filecmp
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import SMOKES as JAX_SMOKES  # noqa: E402
from repro.core import pagestore as jax_pagestore  # noqa: E402
from repro.core import reap as jax_reap  # noqa: E402
from repro.core.arena import ArenaLayout as JaxLayout  # noqa: E402
from repro.core.arena import GuestMemoryFile as JaxGM  # noqa: E402
from repro.core.arena import InstanceArena as JaxArena  # noqa: E402
from repro.core.snapshot import build_instance_snapshot as jax_build  # noqa: E402
from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.core import pagestore as torch_pagestore  # noqa: E402
from repro_torch.core import reap as torch_reap  # noqa: E402
from repro_torch.core.arena import ArenaLayout, GuestMemoryFile, InstanceArena  # noqa: E402
from repro_torch.core.snapshot import build_instance_snapshot  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")
DENSE = sorted(n for n, c in SMOKES.items() if c.family == "dense")


@pytest.mark.parametrize("name", DENSE)
def test_snapshot_bytes_match_jax(tmp_path, name):
    """Same config, same seed: the port's guest-memory file and manifest are
    the JAX package's, byte for byte (host_initialize's RNG law, the bf16
    cast and the layout all agree)."""
    gm_t = build_instance_snapshot(SMOKES[name], str(tmp_path / "t"), seed=3)
    gm_j = jax_build(JAX_SMOKES[name], str(tmp_path / "j"), seed=3)
    assert filecmp.cmp(gm_t.manifest_path, gm_j.manifest_path, shallow=False)
    assert filecmp.cmp(gm_t.mem_path, gm_j.mem_path, shallow=False)


_TENSORS = [
    ("infra/tab", (3000,), "uint8", "infra"),
    ("params/w", (64, 33), "float32", "serve"),
    ("params/e", (40, 2048), "bfloat16", "serve"),
    ("boot/opt", (64, 33), "float32", "boot"),
]
_PKG = {
    "jax": (JaxLayout, JaxGM, JaxArena, jax_reap, jax_pagestore),
    "torch": (ArenaLayout, GuestMemoryFile, InstanceArena, torch_reap,
              torch_pagestore),
}


def _record(pkg: str, base: str) -> None:
    """Build a small guest-memory file and record a WS through ``pkg``."""
    layout_cls, gm_cls, arena_cls, reap_mod, _ = _PKG[pkg]
    rng = np.random.default_rng(11)
    arrays = {
        "infra/tab": rng.integers(0, 255, 3000, dtype=np.uint8),
        "params/w": rng.standard_normal((64, 33)).astype(np.float32),
        "params/e": rng.integers(0, 1 << 16, (40, 2048)).astype(np.uint16),
        "boot/opt": np.ones((64, 33), np.float32),
    }
    gm = gm_cls.create(base, layout_cls.build(_TENSORS), arrays)
    arena = arena_cls(gm)
    arena.tensor("infra/tab")
    arena.tensor_rows("params/e", [31, 2, 7])
    arena.tensor("params/w")
    reap_mod.write_record(gm.base, arena.stats.trace)
    arena.close()


@pytest.fixture()
def stores():
    yield
    jax_pagestore.reset_stores()
    torch_pagestore.reset_stores()
    jax_reap.WS_CACHE.clear()
    torch_reap.WS_CACHE.clear()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_ws_record_reads_across_packages(tmp_path, stores, writer, reader):
    """A REAPWS2 manifest + .pagestore written by one package reads back in
    the other as the same pages and bytes the writer reads."""
    base = str(tmp_path / "fn")
    _record(writer, base)
    w_pages, w_data = _PKG[writer][3]._read_ws(base, _PKG[writer][3].ReapConfig())
    r_pages, r_data = _PKG[reader][3]._read_ws(base, _PKG[reader][3].ReapConfig())
    assert r_pages == w_pages
    assert r_data == w_data
    assert len(w_pages) == len(w_data) // 4096 > 0


def test_ws_record_files_identical(tmp_path, stores):
    """Both packages write the same record files for the same trace: WS
    manifest, trace, and the page store's index and chunk data."""
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        _record(pkg, str(tmp_path / pkg / "fn"))
    for rel in ("fn.ws", "fn.trace.npy", "fn.mem", "fn.manifest.json",
                ".pagestore/index.json", ".pagestore/chunks.data"):
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "torch" / rel,
                           shallow=False), rel


_BLOCKED = r"""
import importlib, pkgutil, sys, tempfile
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
assert {"repro_torch.training.optimizer", "repro_torch.training.checkpoint",
        "repro_torch.training.train_loop", "repro_torch.data.pipeline",
        "repro_torch.launch.train", "repro_torch.launch.mesh",
        "repro_torch.launch.dryrun", "repro_torch.distributed.sharding",
        "repro_torch.distributed.compress", "repro_torch.distributed.step_analysis",
        "repro_torch.analysis.lint", "repro_torch.analysis.lockgraph",
        "repro_torch.analysis.sanitizer"} <= set(names), names
from repro_torch.configs import SMOKES
from repro_torch.core import build_instance_snapshot
d = tempfile.mkdtemp()
gm = build_instance_snapshot(SMOKES["olmo-1b"], d + "/fn")
assert gm.layout.total_bytes > 0
assert not any(m == "jax" or m.startswith(("jax.", "repro.")) for m in sys.modules
               if sys.modules[m] is not None), "jax or repro got imported"
print("OK", len(names))
"""


def test_port_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


def test_sources_name_no_jax_or_repro_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = [f for f in files if _IMPORT.search(open(f).read())]
    assert bad == []
