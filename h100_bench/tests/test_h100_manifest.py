"""BENCHMARK.json and the files it names: every cell loads, and the file
keeps to the contract's shape (names, units, bounds, lengths, layers)."""

import json
import os
import re

import pytest

from h100_bench import manifest
from h100_bench.trace import load_kernel_table

ROOT = manifest.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_loads(cell):
    c = manifest.Cell(cell)
    assert c.model_type in ("bs_roformer", "mel_band_roformer")
    assert set(c.limits) == {"vocals_rel_err", "instrumental_rel_err"}
    e2e = [m["name"] for m, _ in c.metrics(False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics(True)


def test_keys_names_and_lengths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("h100_bench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["why"]) <= 200 and len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert len(m["layer"]) <= 200
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in moved.get("workloads", CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        assert os.path.exists(os.path.join(ROOT, "h100_bench", "metrics", m["name"] + ".py"))
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS) for m in BENCH["per_layer"])
        assert sum(cell in m.get("workloads", CELLS) for m in BENCH["end_to_end"]) >= 2


def test_configs_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert {"audio", "model", "training", "inference", "assumed", "why"} <= set(cfg)
        assert cfg["model"]["stft_hop_length"] == 441 and cfg["audio"]["chunk_size"] == 352800


def test_kernel_table_loads():
    table = load_kernel_table(os.path.join(ROOT, "h100_bench", "kernels"))
    assert set(table) >= {"K1", "K2"}
    k1 = "void sesa::gemm_ws_kernel<3, true>(CUtensorMap_st, CUtensorMap_st, sesa::WsArgs)"
    k2 = "void sesa::gemm_ws_kernel<0, true>(CUtensorMap_st, CUtensorMap_st, sesa::WsArgs)"
    assert any(p.search(k1) for p in table["K1"]["patterns"])
    assert not any(p.search(k1) for p in table["K2"]["patterns"])
    assert any(p.search(k2) for p in table["K2"]["patterns"])
