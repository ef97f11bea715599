"""A configuration, a traffic mix and a per-layer metric added as new files
plus BENCHMARK.json entries are found by name, with no file edited."""

import json
import shutil
from pathlib import Path

from swbench.spec import Spec
from swbench.tests.conftest import TINY, run_cell

ROOT = Path(__file__).resolve().parents[2]


def test_the_benchmark_names_resolve():
    sp = Spec()
    for w in sp.bench["workloads"]:
        cfg = sp.config(w["config"])
        assert cfg["name"] == w["config"]
        assert sp.traffic(w["traffic"])["name"] == w["traffic"]
        assert sp.driver(cfg["driver"]).Session
        for m in sp.metrics_of(w["name"], traced=True):
            assert callable(sp.reader(m["name"]))
        names = {m["name"] for m in sp.metrics_of(w["name"], traced=False)}
        assert "setup_s" in names and len(names) >= 2
    for c in sp.bench["configs"]:
        assert (ROOT / c["file"]).exists()


def test_new_files_are_found_by_name(tmp_path, capsys):
    base = tmp_path / "swbench"
    shutil.copytree(ROOT / "swbench", base,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((base / "configs" / "swissprot_batch.json").read_text())
    cfg["name"] = "swissprot_small"
    cfg["search"]["top_k"] = 5
    (base / "configs" / "swissprot_small.json").write_text(json.dumps(cfg))
    (base / "traffic" / "three_short.json").write_text(json.dumps({
        "name": "three_short", "loop": "closed",
        "queries": {"lengths": [20, 31, 40]}}))
    (base / "layer_metrics" / "batches.small.py").write_text(
        "def read(rec):\n    return float(rec.counters['batches'])\n")
    bench["configs"].append({"name": "swissprot_small", "source": "x",
                             "file": "swbench/configs/swissprot_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small_three", "config":
                               "swissprot_small", "traffic": "three_short",
                               "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "gcups":
            m["workloads"].append("small_three")
    bench["per_layer"].append({"name": "batches.small", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "gcups",
                               "workloads": ["small_three"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    sp = Spec(base)
    assert sp.traffic("three_short")["queries"]["lengths"] == [20, 31, 40]
    rc, out = run_cell(capsys, "small_three", trace=1, spec=sp,
                       overrides={"config": TINY["sp_canonical20"]["config"]})
    assert rc == 0 and out["correct"] is True
    assert out["attempted"] % 3 == 0
    assert out["metrics"]["batches.small"]["value"] >= 1
    rc, out = run_cell(capsys, "small_three", trace=0, spec=sp,
                       overrides={"config": TINY["sp_canonical20"]["config"]})
    assert set(out["metrics"]) == {"gcups", "setup_s"}
