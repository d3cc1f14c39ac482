"""The check's control and its faults.

The control is the reference in the program's place, one precision step
down (float8 e4m3 matmuls for the bf16 model, a bfloat16 scan for the f32
index), read on the same tokens and items and judged by the cell's own
limits: it has to come out not correct (``control.py`` reads it on the
chip at the cells' own sizes; the limits in ``cells/`` are set between the
two).  Then a run with the timed path broken underneath has to come out not
correct, once for each fault a serving cell can have: a decode step that
leaves its state unchanged, half of the batch left out of a step, a token
altered where it is produced, a retrieval answer altered where it is
produced, a sub-stage's merge altered, and a query altered.  (The exchange
between chips: no cell spans chips.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import cells, tiny_run

CONTROLS = {"gen": ("fp8",), "ret": "bf16"}


def test_control_reads_far_worse_than_the_program():
    n = tiny_run("qwen3-rag-qa-online", seconds=3.0, controls=CONTROLS)["numbers"]
    assert n["gen_gap.fp8"] > 3 * n["gen_gap"]
    assert n["gen_gap_mean.fp8"] > 3 * n["gen_gap_mean"]
    assert n["ret_dist_err.bf16"] > 10 * max(n["ret_dist_err"], 1e-7)


@pytest.mark.parametrize("cell", cells())
def test_control_is_judged_not_correct(cell):
    """The control's numbers in the program's place, through the check's own
    judgement by the cell's limits."""
    r = tiny_run(cell, seconds=3.0, controls=CONTROLS)
    assert r["result"]["correct"], r["result"]["checks"]
    control_correct, checks = r["control"]
    assert not control_correct, checks


def test_control_numbers_take_the_programs_place():
    from rag_bench.harness.check import control_numbers

    n = {"gen_gap": 0.01, "gen_gap.fp8": 0.9, "gen_gap.bf16": 0.2, "ret_dist_err": 1e-7,
         "ret_dist_err.bf16": 1e-3, "unfinished": 0, "ret_query": 0}
    c = control_numbers(n, "fp8", "bf16")
    assert c["gen_gap"] == 0.9 and c["ret_dist_err"] == 1e-3
    assert c["unfinished"] == 0 and c["ret_query"] == 0
    assert control_numbers(n, None, None)["gen_gap"] == 0.01


def _step_unchanged(stack, mp):
    eng = stack.engine
    eng._graph = None  # the eager body, so that the fault takes effect on a card too

    def decode():  # the step returns the last tokens and writes nothing
        eng._next_tokens.copy_(eng._last_tokens)
    eng._decode = decode


def _half_batch(stack, mp):
    eng = stack.engine
    eng._graph = None
    orig = eng._decode

    def decode():  # the upper half of the slots is left out: its outputs stay cleared
        orig()
        h = eng.max_batch // 2
        eng._next_tokens[h:] = 0
        eng._last_tokens[h:] = 0
    eng._decode = decode


def _token_altered(stack, mp):
    eng = stack.engine
    eng._graph = None
    orig = eng._decode

    steps = [0]

    def decode():  # one slot's token altered a step, the slot turning round
        orig()
        s = steps[0] % eng.max_batch
        steps[0] += 1
        eng._next_tokens[s] = (eng._next_tokens[s] + 1) % stack.mc.vocab_size
        eng._last_tokens[s] = eng._next_tokens[s]
    eng._decode = decode


def _answer_altered(stack, mp):
    hyb = stack.hybrid
    orig = hyb.search_plan

    def search_plan(plan, **kw):
        out = orig(plan, **kw)
        out.ids[:, [0, -1]] = out.ids[:, [-1, 0]]  # best and k-th swapped
        return out
    hyb.search_plan = search_plan


def _merge_altered(stack, mp):
    from repro_torch.retrieval.plan import RetrievalPlan

    orig = RetrievalPlan.finalize

    def finalize(self, results):  # the merge keeps the worse of each pair
        res = orig(self, results)
        res.dists[:, [0, -1]] = res.dists[:, [-1, 0]]
        res.ids[:, [0, -1]] = res.ids[:, [-1, 0]]
        return res
    mp.setattr(RetrievalPlan, "finalize", finalize)


def _query_altered(stack, mp):
    from repro_torch.core.backends import RealBackend

    orig = RealBackend.query_embedding

    def query_embedding(self, req, round_idx):  # the request's query for another round
        return np.asarray(orig(self, req, round_idx + 1), np.float32)
    mp.setattr(RealBackend, "query_embedding", query_embedding)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _token_altered, _answer_altered,
                                   _merge_altered, _query_altered],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("cell", cells())
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    res = tiny_run(cell, seconds=4.0, fault=lambda stack: fault(stack, monkeypatch))["result"]
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_at_a_cells_size_is_not_correct(card, cell):
    """On the card, at the cell's own size and load: the program comes out
    correct and the control, judged by the same limits, not correct
    (``control.py`` reads more seeds)."""
    from rag_bench import run

    spec = run.load_spec(cell)
    r = run.run_cell(torch, card, spec, 424242, 12.0, False, controls=CONTROLS,
                     out=lambda *a: None)
    assert r["result"]["correct"], r["result"]["checks"]
    control_correct, checks = r["control"]
    assert not control_correct, checks
