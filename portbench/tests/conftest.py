"""Shared pieces of the benchmark's tests: the ``card`` marker for tests
that need a CUDA card (they decide inside the fixture, so every worker
collects the same tests), and a temporary checkout root holding the
benchmark's parts with small cells added as files."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


#: small cells on the CPU: case118 at 8 scenarios a call
SMALL = {
    "case118.nr_small": ("nr_fleet.b1024", "case118.nr_fleet"),
    "case118.se_small": ("se_fleet.b1024", "case118.se_fleet"),
}


def make_small_root(tmp_path):
    """A root holding BENCHMARK.json and the benchmark's folder, with the
    cells of ``SMALL`` added: their traffic files (8 scenarios a call, two
    calls checked), limits and entries."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    doc = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench = tmp_path / "portbench"
    for cell, (mix, like) in SMALL.items():
        params = json.loads((bench / "traffic" / f"{mix}.json").read_text())
        params.update(scenarios=8, check_calls=2)
        name = cell.split(".")[1]
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(params))
        shutil.copy(bench / "limits" / f"{like}.json",
                    bench / "limits" / f"{cell}.json")
        doc["workloads"].append(dict(name=cell, config="case118",
                                     traffic=name, chips=1, why="test"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    return tmp_path


@pytest.fixture
def small_root(tmp_path):
    return make_small_root(tmp_path)
