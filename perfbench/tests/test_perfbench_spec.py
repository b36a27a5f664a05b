"""BENCHMARK.json against the contract's characters and limits, and every
configuration, mix, limit file and reader found by its name."""

import json
import os
import re

import pytest

from perfbench import HERE, ROOT, harness, traffic_gen

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(text_ok(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in BENCH["command"][1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_texts():
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in BENCH[group]]
        assert len(seen) == len(set(seen))
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
        names |= set(seen)
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["why"]) and text_ok(c["source"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and text_ok(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {n.split(".")[0] for n in e2e} <= {"frames_per_s", "chunk_ms_p90",
                                              "setup_s"}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert text_ok(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        for cell in m.get("workloads", cells):  # each reports what it moves
            assert m["moves"] in [x["name"] for x in harness.cell_metrics(
                BENCH, "end_to_end", cell)]
        if "roofline" in m["name"]:  # <kernel>_roofline[.<cells>]
            assert m["name"].split(".")[0].endswith("_roofline")
            assert m["unit"] == "%"
    for cell in cells:  # every cell reports an end-to-end and a layer metric
        assert harness.cell_metrics(BENCH, "per_layer", cell)
        assert len(harness.cell_metrics(BENCH, "end_to_end", cell)) >= 2


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_found_by_name(cell):
    cfgs = {c["name"]: c for c in BENCH["configs"]}
    cfg_file = cfgs[cell["config"]]["file"]
    assert cfg_file == f"perfbench/configs/{cell['config']}.json"
    cfg = json.load(open(os.path.join(ROOT, cfg_file)))
    for role in ("detector", "encoder", "classifier", "emotion"):
        if cfg.get(role):
            mod = harness.net_module(cfg[role]["net"])
            assert mod.KIND == role
    mix = traffic_gen.load_mix(cell["traffic"])
    assert mix["pool_chunks"] >= 2
    limits = json.load(open(os.path.join(HERE, "limits",
                                         f"{cell['name']}.json")))
    assert limits and all(isinstance(v, (int, float))
                          for v in limits.values())
    for m in harness.cell_metrics(BENCH, "per_layer", cell["name"]):
        assert callable(harness.metric_reader(m["name"]))


def test_every_config_used_once_per_traffic():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {p[0] for p in pairs}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
