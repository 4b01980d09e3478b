"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import re

import pytest

from chipbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(not p.endswith("_torch") and ".." not in p for p in MAN["paths"])
    assert len(MAN["command"]) <= 32 and all(line(w) for w in MAN["command"])
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if metric in MAN["end_to_end"] else {"layer", "moves"}
    assert set(metric) - {"workloads"} == keys
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(metric["layer"])
        assert (harness.HERE / "metrics" / f"{metric['name']}.py").is_file()
    if "roofline" in metric["name"] or "mfu" in metric["name"] or "share" in metric["name"]:
        assert metric["unit"] == "%"
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_every_cell_of_a_per_layer_metric_reports_what_it_moves(metric):
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert metric["moves"] in e2e
    for cell in metric["workloads"]:
        assert metric["moves"] in {m["name"] for m in harness.end_to_end_for(MAN, cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_and_reports(cell):
    w = harness.cell_entry(MAN, cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"} and line(w["why"])
    assert w["chips"] in (1, 4)
    assert w["config"] in {c["name"] for c in MAN["configs"]}
    assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    mode = harness.cell_file(cell)["mode"]
    assert (harness.HERE / "modes" / f"{mode}.py").is_file()
    e2e = [m["name"] for m in harness.end_to_end_for(MAN, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.per_layer_for(MAN, cell)


def test_pairs_of_config_and_traffic_appear_once_and_four_chips_are_rare():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("chipbench/configs/") and line(entry["source"])
    cfg = harness.config_file(entry["name"])
    assert cfg["name"] == entry["name"] and cfg["reduced"] == entry["reduced"]
    widths = ("size", "_dim", "_rank", "heads", "factor", "experts_per_tok")
    assert not any(w in k for k in entry["reduced"] for w in widths)
    for key in entry["reduced"]:
        assert cfg["published"][key] != cfg[key]
    assert any(w["config"] == entry["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda c: c["name"])
def test_config_family_and_reference_are_found_by_name(entry):
    """Each configuration names its family and its reference, and both
    exist as files: a configuration of a new family adds files only."""
    cfg = harness.config_file(entry["name"])
    assert (harness.HERE / "families" / f"{cfg['family']}.py").is_file()
    assert (harness.HERE / "configs" / f"{cfg['reference']}.py").is_file()
    fam = harness.family(cfg)
    for fn in ("leaf_specs", "port_config", "train_flops", "prefill_work", "decode_step_work"):
        assert callable(getattr(fam, fn)), fn


def test_files_are_named_from_name_characters():
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        assert PATH.match(path.relative_to(harness.ROOT).as_posix())
