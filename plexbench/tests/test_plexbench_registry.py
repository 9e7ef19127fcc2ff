"""The harness finds cells, configurations, mixes, metrics, references and
port mappings by name, and picks up new files without an edit."""
import json
import shutil
from pathlib import Path

import pytest

from plexbench import harness

REPO = harness.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_what_it_names(name):
    cell = harness.Cell(name)
    assert cell.config["registry"]
    assert cell.traffic["kind"] in ("train", "rollout")
    for kind in ("kinds", "reference", "port"):
        assert cell.module(kind) is not None
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    assert cell.limits, "every cell has its limits file"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_hold_the_published_sizes(entry):
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    from plexbench.session import port_overrides
    assert port_overrides(cfg) == ()


def test_every_metric_entry_names_a_reader_and_real_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert (harness.PB / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells


def _copy(tmp_path: Path) -> Path:
    """A checkout holding BENCHMARK.json and plexbench/ alone."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PB, root / "plexbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    return root


def test_new_mix_and_metric_files_are_picked_up_without_an_edit(tmp_path):
    root = _copy(tmp_path)
    pb = root / "plexbench"
    mix = json.loads((pb / "traffic" / "train_solo.json").read_text())
    mix["response_len"] = 256
    (pb / "traffic" / "train_short.json").write_text(json.dumps(mix))
    (pb / "metrics" / "forward_s.train.py").write_text(
        "from plexbench import readers\n\n\ndef read(rec):\n"
        "    return readers.mean_exec(rec, 'forward')\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "qwen2-0.5b.train_short",
                               "config": "qwen2-0.5b",
                               "traffic": "train_short", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "forward_s.train", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "execution",
                               "moves": "train_tokens_per_s",
                               "workloads": ["qwen2-0.5b.train_short"]})
    cell = harness.Cell("qwen2-0.5b.train_short", bench, root=root,
                        data=pb)
    assert cell.traffic["response_len"] == 256
    assert [m["name"] for m in cell.per_layer] == ["forward_s.train"]
    reader = harness.load_module(pb / "metrics" / "forward_s.train.py")
    rec = type("R", (), {})()
    rec.window = (0.0, 10.0)
    rec.spans = [{"ok": True, "submit": 1.0, "resolve": 2.0, "op": "forward",
                  "exec_s": 0.5}, {"ok": True, "submit": 3.0,
                                   "resolve": 4.0, "op": "forward",
                                   "exec_s": 0.7}]
    assert reader.read(rec) == pytest.approx(0.6)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such_cell")
