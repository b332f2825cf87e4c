"""Finds a cell's files by name: its entry in ``BENCHMARK.json``, its
workload file ``workloads/<cell>.json`` (configuration, traffic and
cadence), its configuration ``configs/<config>.json`` and the reader of
each per-layer metric, ``metrics/<metric>.py``.  Adding a cell, a
configuration or a metric adds files; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    """``BENCHMARK.json`` and the files under ``base`` (the benchmark's
    folder) that it names."""

    def __init__(self, bench_json: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.spec = json.loads(Path(bench_json).read_text())
        self.base = Path(base)

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"BENCHMARK.json names no {key[:-1]} {name!r}")

    def cell(self, name: str) -> dict:
        """The workload file of cell ``name``, checked against its
        ``BENCHMARK.json`` entry."""
        entry = self._entry("workloads", name)
        wl = json.loads((self.base / "workloads" / f"{name}.json").read_text())
        for k in ("config", "traffic", "chips"):
            if wl[k] != entry[k]:
                raise ValueError(f"workloads/{name}.json has {k}={wl[k]!r}, "
                                 f"BENCHMARK.json {entry[k]!r}")
        return wl

    def config(self, name: str) -> dict:
        self._entry("configs", name)
        return json.loads((self.base / "configs" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> list[dict]:
        """The end-to-end metrics cell ``cell`` reports: every cell reports
        each."""
        self._entry("workloads", cell)
        return self.spec["end_to_end"]

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics whose ``workloads`` list cell ``cell``."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]

    def reader(self, metric: str):
        """``read`` of ``metrics/<metric>.py``, loaded by path."""
        path = self.base / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
