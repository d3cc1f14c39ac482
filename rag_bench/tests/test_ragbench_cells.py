"""Every cell end to end at the tiny size on the CPU (the kernels' plain
versions): set-up, warm-up, the window through the wall-clock ingress, the
check; the result line carries what the contract asks for."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, cells, tiny_run

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def reported(kind: str, cell: str) -> set:
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])}


@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_at_tiny_size(cell):
    r = tiny_run(cell, seed=2**31 + 12345)
    res = r["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == reported("end_to_end", cell)
    assert list(res)[-1] == "checks" and set(res) >= {"correct", "attempted", "failed",
                                                      "metrics", "device"}
    n = r["numbers"]
    assert n["gen_tokens"] > 0 and n["ret_device_items"] > 0 and n["ret_host_items"] > 0
    assert n["ret_groups"] > 0 and n["ret_query"] == 0
    json.dumps(res)


def test_traced_run_reports_per_layer_metrics_only():
    cell = "qwen3-rag-qa-online"
    res = tiny_run(cell, seconds=3.0, trace=True)["result"]
    assert res["correct"], res["checks"]
    # on the CPU the profiler traces no device op: the device's metrics are left out
    host_side = {m for m in reported("per_layer", cell)
                 if not any(k in m for k in ("roofline", "idle"))}
    assert set(res["metrics"]) == host_side


def test_same_seed_same_inputs():
    """The seed alone fixes the weights, corpus, prompts and arrivals."""
    import torch

    from rag_bench import run
    from rag_bench.harness import serve

    spec = run.load_spec("qwen3-rag-qa-online")
    a, b = (serve.Stack(torch, torch.device("cpu"), spec["config"], spec["mix"], 7, tiny=True,
                        log=lambda *x: None) for _ in range(2))
    assert torch.equal(a.params["embed"], b.params["embed"])
    assert (a.docs == b.docs).all()
    assert [a.next_prompt()[0].tolist() for _ in range(3)] == [b.next_prompt()[0].tolist()
                                                               for _ in range(3)]
