"""A configuration, a mix, a cell or a metric is added by adding files and
entries: the harness finds each by its name, and no existing file changes."""
import json
import shutil
from pathlib import Path

from portbench import spec


def _copy_checkout(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_every_named_piece_has_its_file():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c["config"]["name"] == w["config"]
        for m in c["end_to_end"] + c["per_layer"]:
            assert callable(spec.reader(m["name"]))
    for conf in bench["configs"]:
        assert (spec.ROOT / conf["file"]).is_file()


def test_new_configuration_mix_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy_checkout(tmp_path)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    here = root / "portbench"
    conf = json.loads((here / "configs" / "olmo-1b.json").read_text())
    conf["name"] = "olmo-1b-copy"
    (here / "configs" / "olmo-1b-copy.json").write_text(json.dumps(conf))
    mix = json.loads((here / "mixes" / "warm-score.json").read_text())
    (here / "mixes" / "warm-long.json").write_text(json.dumps(dict(mix, lengths=[4096],
                                                                   weights=[1.0])))
    (here / "cells" / "olmo-1b-copy.warm-long.json").write_text(
        json.dumps({"limits": {"logit_err": 1.0}}))
    (here / "metrics" / "longest_tokens.py").write_text(
        "def read(rec):\n    return max(r['tokens'] for r in rec['requests'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "olmo-1b-copy", "source": "x",
                             "file": "portbench/configs/olmo-1b-copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "olmo-1b-copy.warm-long", "config": "olmo-1b-copy",
                               "traffic": "warm-long", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "longest_tokens", "unit": "tokens",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "prompt_tokens_per_s",
                               "workloads": ["olmo-1b-copy.warm-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell(spec.load_benchmark(root), "olmo-1b-copy.warm-long", root)
    assert c["config"]["name"] == "olmo-1b-copy"
    assert c["mix"]["lengths"] == [4096]
    assert c["cell"]["limits"] == {"logit_err": 1.0}
    assert [m["name"] for m in c["per_layer"]] == ["longest_tokens"]
    read = spec.reader("longest_tokens", root)
    assert read({"requests": [{"tokens": 3}, {"tokens": 9}]}) == 9
    # the old cells see nothing of it, and no file that was there changed
    old = spec.cell(spec.load_benchmark(root), "olmo-1b.warm-score", root)
    assert "longest_tokens" not in [m["name"] for m in old["per_layer"]]
    assert all(p.read_bytes() == b for p, b in before.items())
