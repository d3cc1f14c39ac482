"""The benchmark's files: every configuration, mix, cell and metric named in
BENCHMARK.json is found by its name, and the file keeps to the contract's
shape."""
from __future__ import annotations

import json
import re

import numpy as np

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["rag_bench"]
    assert BENCH["command"] == ["python3", "rag_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


CHIPS = re.compile(r"\b(\d+) (?:chips|cards|GPUs) share (?:each|every|a) layer\b")


def share_key(key: str) -> bool:
    """The key that counts the routed experts (not those a token takes, not
    the shared ones), or the vocabulary: what a chip's share may cut."""
    return key == "vocab_size" or ("experts" in key and not any(
        s in key for s in ("per_tok", "shared", "group")))


def reduced_problems(f: dict) -> list:
    """What a configuration file's ``reduced`` may not list.  No width (a
    key ending in _dim, _rank or _size) and no count of experts, except the
    chip's share of a stated deployment, where each layer is divided over
    several chips and this one holds its part: the routed experts held on
    this chip, or a sliced ``vocab_size``, each with
    its published value under ``published`` and a ``deployment`` that says
    how many chips share a layer ("8 chips share each layer"), this chip
    holding its share of them, rounded up."""
    out = []
    for key in f["reduced"]:
        if share_key(key):
            chips = CHIPS.search(f.get("deployment", ""))
            pub = f.get("published", {}).get(key)
            if chips is None or not isinstance(pub, int):
                out.append(f"{key}: no published count, or no chips sharing a layer")
            elif f[key] != -(-pub // int(chips[1])):
                out.append(f"{key}: {f[key]} is not the share of {pub} over {chips[1]} chips")
        elif key.endswith(("_dim", "_rank", "_size")) or "experts" in key:
            out.append(f"{key}: a width or a count of experts")
    return out


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_found_by_name(cfg):
    f = json.loads((ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"rag_bench/configs/{cfg['name']}.json"
    assert f["source"] == cfg["source"]
    assert f["reduced"] == cfg["reduced"]
    for d in ("reference", "families"):
        assert (ROOT / "rag_bench" / d / f"{f['model_type']}.py").is_file()
    assert reduced_problems(f) == []


def test_only_the_chips_share_may_cut_experts_or_the_vocabulary():
    deploy = "one H100 of a node where 4 chips share each layer"
    f = {"num_experts": 32, "vocab_size": 50048, "num_experts_per_tok": 8, "deployment": deploy,
         "published": {"num_experts": 128, "vocab_size": 200192},
         "reduced": ["num_experts", "vocab_size", "rope_scaling"]}
    assert reduced_problems(f) == []
    for bad in (dict(f, num_experts=64), dict(f, deployment="one H100"),
                dict(f, published={"vocab_size": 200192}),
                dict(f, reduced=["num_experts_per_tok"]), dict(f, reduced=["n_shared_experts"]),
                dict(f, reduced=["moe_intermediate_size"]), dict(f, reduced=["head_dim"])):
        assert reduced_problems(bad), bad


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_found_by_name(cell):
    """Each cell's mix and cell file by name; an open loop with its rate."""
    mix = json.loads((ROOT / "rag_bench" / "traffic" / f"{cell['traffic']}.json").read_text())
    own = json.loads((ROOT / "rag_bench" / "cells" / f"{cell['name']}.json").read_text())
    assert mix["loop"] == "open" and own["rate_rps"] > 0
    lim = set(own["limits"])
    assert lim >= {"ret_dist_err", "ret_rank_err", "ret_query", "unfinished", "partition"}
    assert lim & {"gen_gap", "gen_gap_mean"} and lim <= {"gen_gap", "gen_gap_mean", "gen_miss",
                                                         "ret_dist_err", "ret_rank_err",
                                                         "ret_query", "unfinished", "partition"}
    assert cell["chips"] == 1 and len(cell["why"]) <= 200 and NAME.match(cell["name"])
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    from rag_bench.harness.readings import reader

    assert callable(reader(metric["name"]))
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {c["name"] for c in BENCH["workloads"]}
    if "layer" in metric:  # per-layer: every listed cell reports the metric it moves
        moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
        for w in metric.get("workloads", cells):
            assert w in cells and w in moves.get("workloads", cells)
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25


def test_every_cell_reports_setup_another_and_a_layer():
    for c in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if c["name"] in m.get("workloads", [c["name"]])]
        layers = [m for m in BENCH["per_layer"] if c["name"] in m.get("workloads", [c["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2 and layers


def test_mix_files_load_and_draw():
    from rag_bench.harness import traffic as tr

    for path in sorted((ROOT / "rag_bench" / "traffic").glob("*.json")):
        mix = json.loads(path.read_text())
        a = tr.make_pools(mix, 64, 1.1, seed=3)
        b = tr.make_pools(mix, 64, 1.1, seed=2**33 + 5)
        # every seed draws the same work in another order
        for f in ("workflow", "topic", "rounds", "prompt", "max_new"):
            for lo in range(0, mix["pool"], tr.BLOCK):  # each block: the same draws
                sa, sb = getattr(a, f)[lo: lo + tr.BLOCK], getattr(b, f)[lo: lo + tr.BLOCK]
                assert sorted(sa.tolist()) == sorted(sb.tolist())
        assert not (a.prompt == b.prompt).all()
        lo, hi = mix["prompt_tokens"]["lo"], mix["prompt_tokens"]["hi"]
        assert a.prompt.min() >= lo and a.prompt.max() <= hi
        counts = {n: int((a.workflow[:tr.BLOCK] == i).sum()) for i, n in enumerate(a.names)}
        assert max(counts.values()) - min(counts.values()) <= 1
        # the same arrivals in another order
        x = tr.open_loop_schedule(mix, a, 3.0, 30.0)
        y = tr.open_loop_schedule(mix, b, 3.0, 30.0)
        assert len(x) == len(y) == 90 and x != y and x[-1][0] < 30.0
        gx, gy = (sorted(np.diff([0.0] + [t for t, _ in s])) for s in (x, y))
        assert np.allclose(gx, gy)
