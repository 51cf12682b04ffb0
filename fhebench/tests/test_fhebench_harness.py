"""The harness at CI presets on the CPU: every circuit runs through it and
yields the contract's last line; new configurations, mixes, cells and
metrics are found as files; the command refuses to run without a card."""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import types
import weakref

import pytest
import torch

from fhebench import harness

import fhebench_ci as ci

E2E = ["req_per_s", "latency_p50_ms", "latency_p95_ms", "peak_mem_gib", "setup_s"]


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(ci.CI))
def test_cell_runs_at_ci(name):
    line = ci.run(name)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert line["correct"] is True, line["checked"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line["metrics"]) == E2E
    for m in line["metrics"].values():
        assert isinstance(m["value"], float) and isinstance(m["unit"], str)
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 1,
                              "memory_peak_bytes": 0}
    for c in line["checked"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


def test_traced_line_at_ci(monkeypatch):
    # one request with its phases marked, then the two profiled ones
    monkeypatch.setattr(harness, "TRACE_SLICE", (0.5, 0.0, 1, 1))
    line = ci.run("ckks_n16_dw.boot", seconds=1.0, trace=True)
    assert line["correct"] is True
    # the CPU traces no kernel: only the phase events give a metric here
    assert set(line["metrics"]) == {"boot.transforms_ms", "boot.evalmod_ms"}
    assert line["metrics"]["boot.evalmod_ms"]["value"] > 0
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "checked"


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    for kind in ("configs", "traffic", "cells", "circuits", "metrics"):
        shutil.copytree(harness.HERE / kind, tmp_path / kind)
    cfg, mix, cell = ci.files("n16_int.bgv_mul5")
    (tmp_path / "configs" / "int_ci.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "bgv_mul2.json").write_text(json.dumps(dict(mix, depth=2)))
    (tmp_path / "cells" / "int_ci.bgv_mul2.json").write_text(json.dumps(cell))
    (tmp_path / "metrics" / "host.requests_traced.py").write_text(
        "def read(tr):\n    return float(tr.requests)\n")
    man = harness.manifest()
    man["workloads"].append({"name": "int_ci.bgv_mul2", "config": "int_ci",
                             "traffic": "bgv_mul2", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "host.requests_traced", "unit": "req", "better": "higher",
                             "source": "program_counter", "layer": "host", "moves": "req_per_s",
                             "workloads": ["int_ci.bgv_mul2"]})
    monkeypatch.setattr(harness, "HERE", tmp_path)
    monkeypatch.setattr(harness, "manifest", lambda: man)
    monkeypatch.setattr(harness, "TRACE_SLICE", (0.0, 0.0, 1, 1))
    line = harness.run_cell("int_ci.bgv_mul2", 7, 0.3, True, device="cpu")
    assert line["correct"] is True
    assert line["metrics"] == {"host.requests_traced": {"value": 1.0, "unit": "req"}}


class _Held:
    pass


def test_window_collects_each_request_garbage(monkeypatch):
    # each request leaves an object in a reference cycle; the window
    # collects it before the next request, whatever the automatic
    # collector's thresholds, and gives the collector back as it was
    alive, seen = weakref.WeakSet(), []
    load = harness.load_module

    def load_module(kind, name):
        mod = load(kind, name)
        if kind == "circuits":
            class Circuit(mod.Circuit):
                def request(self, ct):
                    seen.append(len(alive))
                    held = _Held()
                    held.self = held
                    alive.add(held)
                    return super().request(ct)

            mod = types.SimpleNamespace(**vars(mod))
            mod.Circuit = Circuit
        return mod

    monkeypatch.setattr(harness, "load_module", load_module)
    threshold, frozen = gc.get_threshold(), gc.get_freeze_count()
    gc.set_threshold(100000)  # no automatic collection would come in time
    try:
        line = ci.run("n16_int.bgv_mul5", seconds=0.3)
    finally:
        gc.set_threshold(*threshold)
    assert line["correct"] is True and line["attempted"] >= 2
    # the warm-up's garbage lives until set-up ends, the window's not past
    # its request
    n_warm = len(seen) - line["attempted"]
    assert seen[:n_warm] == list(range(n_warm))
    assert seen[n_warm:] == [0] * line["attempted"]
    assert gc.isenabled() and gc.get_freeze_count() == frozen


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload",
                           "n16_int.bgv_mul5", "--seed", "1", "--seconds", "1"],
                          cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA card" in proc.stderr
    assert proc.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["n16_int.bgv_mul5", "ckks_n16_dw.mul8"])
def test_command_on_the_card(card, name):
    proc = subprocess.run([sys.executable, "-m", "fhebench.run", "--workload", name, "--seed",
                           "2147483659", "--seconds", "2", "--trace", "1"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    assert {"k1_roofline", "k4_roofline", "device.idle_pct"} <= set(line["metrics"])
    assert proc.stderr.strip().splitlines()[-1].startswith("checked ")
