"""``BENCHMARK.json`` and the files it names keep to the benchmark's
rules: names, units and lengths, one file a thing found by its name,
every per-layer metric reported where the metric it moves is, and the
operation counts against hand counts."""

from __future__ import annotations

import json
import math
import os
import re

import pytest

from gxbench.cell import HERE, ROOT, load_cell, load_file

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_CHARS = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert bench["paths"] == ["gxbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    # a full check of 24 cells fits its 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_text(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(("config", c["name"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(("workload", w["name"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert all(NAME.match(n) for _, n in names)
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_files_under_paths_are_named_from_name_characters():
    for dirpath, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert PATH_CHARS.match(rel), rel


def test_each_workload_finds_its_files(bench):
    files = {c["name"]: c["file"] for c in bench["configs"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(files)                 # each configuration used
    assert len(set(files.values())) == len(files)
    for w in bench["workloads"]:
        path = os.path.join(ROOT, files[w["config"]])
        assert os.path.isfile(path) and path.startswith(HERE + os.sep)
        cell = load_cell(w["name"])
        assert cell.workload["name"] == w["name"]
        assert cell.config["name"] == w["config"]
        assert len(cell.workload["why"]) <= 200
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)


def test_a_workload_kept_for_later_loads_from_its_files_alone(bench):
    named = {w["name"] for w in bench["workloads"]}
    kept = sorted(f[:-len(".json")] for f in os.listdir(
        os.path.join(HERE, "workloads")) if f[:-len(".json")] not in named)
    assert kept
    for name in kept:
        cell = load_cell(name)
        assert cell.entry["name"] == cell.workload["name"] == name
        assert cell.config["name"] == cell.workload["config"]
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert all("workloads" not in m or name in m["workloads"]
                   for m in cell.end_to_end + cell.per_layer)
        assert len(cell.workload["why"]) <= 200
    with pytest.raises(SystemExit):
        load_cell("no.such.cell")


def test_every_cell_reports_what_its_metrics_move(bench):
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names
        for name in m.get("workloads", []):
            assert name in {w["name"] for w in bench["workloads"]}


def test_reduced_lists_no_width(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key not in (
                "dim", "num_heads", "stage_filters", "mlp_dim")


def test_counts_match_hand_counts():
    with open(os.path.join(HERE, "configs", "resnet20_cifar10.json")) as f:
        resnet = json.load(f)
    count = load_file(os.path.join(HERE, "counts", "resnet20_cifar10.py"))
    # stem 2*9*3*16*32*32; stage 1: six 16->16 convs at 32x32; stages 2
    # and 3: a strided conv, five more, a 1x1 projection; the head
    conv = 2 * 9 * 16 * 16 * 32 * 32
    hand = 2 * 9 * 3 * 16 * 1024 + 6 * conv + 2 * (conv // 2 + 5 * conv) \
        + 2 * (2 * 16 * 32 * 256) + 2 * 64 * 10
    assert count.forward_flops_per_sample(resnet) == hand == 81_626_368
    assert math.isclose(hand / 1e6, 81.6, abs_tol=0.05)
    with open(os.path.join(HERE, "configs", "lra_text_encoder.json")) as f:
        enc = json.load(f)
    count = load_file(os.path.join(HERE, "counts", "lra_text_encoder.py"))
    L, D = 4096, 256
    layer = 2 * L * D * 768 + 4 * L * L * D + 2 * L * D * D \
        + 4 * L * D * 1024
    assert count.forward_flops_per_sample(enc) == 4 * layer + 2 * D * 2
    assert round(4 * layer / 1e9, 2) == 94.49


def test_reference_specs_count_the_published_weights():
    from gxbench.reference import resnet_cifar, seq_encoder
    for name, mod in (("resnet20_cifar10", resnet_cifar),
                      ("lra_text_encoder", seq_encoder)):
        with open(os.path.join(HERE, "configs", name + ".json")) as f:
            cfg = json.load(f)
        n = sum(math.prod(s) for _, s, _, _ in mod.param_specs(cfg))
        assert n == cfg["parameters"]
