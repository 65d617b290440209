"""``BENCHMARK.json`` against the benchmark's contract: keys, names and
units in the allowed characters, every file it names present, and the
files each entry is found by."""

import json
import re

import pytest

from helpers import BENCH, REPO

MAN = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and not any(
        c in text for c in "\n\r\t")


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    for word in MAN["command"]:
        assert one_line(word)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    names += [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [w["config"] for w in MAN["workloads"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    names += [k for c in MAN["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in MAN[group]]
        assert len(got) == len(set(got)), group
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in MAN["configs"] + MAN["workloads"]:
        assert one_line(e["why"])
    for m in MAN["per_layer"]:
        assert one_line(m["layer"])
    for c in MAN["configs"]:
        assert one_line(c["source"]) and c["source"].startswith("https://")


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [n for n, m in e2e.items() if cell in m.get("workloads",
                                                           cells)]
        assert "setup_s" in mine and len(mine) >= 2
        layers = [m for m in MAN["per_layer"]
                  if cell in m.get("workloads", cells)]
        assert layers
        for m in layers:
            assert m["moves"] in mine


def test_configs_are_files_of_their_own_and_used():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in MAN["workloads"]}
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/configs/")
        doc = json.loads((REPO / c["file"]).read_text())
        assert doc["name"] == c["name"]
        assert sorted(doc["reduced"]) == sorted(c["reduced"])
        assert doc["source"] == c["source"]


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_traffic_and_runner(w):
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (BENCH / "runners" / f"{traffic['runner']}.py").is_file()
    pairs = [(x["config"], x["traffic"]) for x in MAN["workloads"]]
    assert pairs.count((w["config"], w["traffic"])) == 1


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    from portbench import harness

    assert callable(harness.reader_of(m["name"]).read)


def test_four_chip_cells_within_the_share():
    four = [w for w in MAN["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(MAN["workloads"]) // 4)
