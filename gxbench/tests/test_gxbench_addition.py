"""A later configuration, cell or per-layer metric is taken up by adding
files and entries alone: in a copy of the benchmark, a new configuration
file with its count, a new workload file and a new metric reader are
found by name, and no file that was there changes."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from gxbench.cell import HERE, ROOT, load_cell


def _digests(root):
    out = {}
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def _write(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def test_new_config_cell_and_metric_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    here = root / "gxbench"
    shutil.copytree(HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)

    # a configuration: ResNet-56 (n = 9) of the same family
    with open(here / "configs" / "resnet20_cifar10.json") as f:
        cfg = json.load(f)
    cfg.update(name="resnet56_cifar10", stage_sizes=[9, 9, 9],
               parameters=0)
    _write(here / "configs" / "resnet56_cifar10.json", cfg)
    shutil.copy(here / "counts" / "resnet20_cifar10.py",
                here / "counts" / "resnet56_cifar10.py")
    # a cell on it
    with open(here / "workloads" / "resnet20.hips_bsc.b1024.json") as f:
        wl = json.load(f)
    wl.update(name="resnet56.dense.b1024", config="resnet56_cifar10",
              traffic="dense.b1024", dc_compression="none")
    _write(here / "workloads" / "resnet56.dense.b1024.json", wl)
    # a per-layer metric that only that cell reports
    (here / "metrics" / "loss_reads.mesh.py").write_text(
        "def read(run):\n    return float(run.out.steps)\n")
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"].append({"name": "resnet56_cifar10",
                             "source": "https://arxiv.org/abs/1512.03385",
                             "file": "gxbench/configs/resnet56_cifar10.json",
                             "reduced": [], "why": "n = 9"})
    bench["workloads"].append({"name": "resnet56.dense.b1024",
                               "config": "resnet56_cifar10",
                               "traffic": "dense.b1024", "chips": 1,
                               "why": "bypasses BSC"})
    bench["per_layer"].append({"name": "loss_reads.mesh", "unit": "1",
                               "better": "lower", "source": "host_clock",
                               "layer": "fit loop",
                               "moves": "train_samples_per_s",
                               "workloads": ["resnet56.dense.b1024"]})
    _write(root / "BENCHMARK.json", bench)

    cell = load_cell("resnet56.dense.b1024", root=str(root), here=str(here))
    assert cell.config["stage_sizes"] == [9, 9, 9]
    assert cell.counts.forward_flops_per_sample(cell.config) > \
        load_cell("resnet20.hips_bsc.b1024").counts \
        .forward_flops_per_sample(cfg | {"stage_sizes": [3, 3, 3]})
    assert "loss_reads.mesh" in [m["name"] for m in cell.per_layer]
    reader = cell.reader("loss_reads.mesh")
    assert reader.read(type("R", (), {"out": type("O", (), {"steps": 7})})
                       ) == 7.0
    old = load_cell("resnet20.hips_bsc.b1024", root=str(root),
                    here=str(here))
    assert "loss_reads.mesh" not in [m["name"] for m in old.per_layer]

    after = _digests(root)
    changed = [p for p, d in before.items()
               if p != "BENCHMARK.json" and after.get(p) != d]
    assert changed == []
    assert set(after) - set(before) == {
        os.path.join("gxbench", "configs", "resnet56_cifar10.json"),
        os.path.join("gxbench", "counts", "resnet56_cifar10.py"),
        os.path.join("gxbench", "workloads", "resnet56.dense.b1024.json"),
        os.path.join("gxbench", "metrics", "loss_reads.mesh.py")}
