"""The plain reference against the port at a tiny size on the CPU (f32):
the same seeded weights through the port's forward pass and through the
reference give the same logits, and the exact scan gives the port's
cluster answers."""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import ROOT


def tiny(config: str):
    from rag_bench.harness.serve import file_view, model_config

    f = json.loads((ROOT / "rag_bench" / "configs" / f"{config}.json").read_text())
    mc = dataclasses.replace(model_config(torch, f, tiny=True), dtype="float32")
    return mc, file_view(f, mc)


@pytest.mark.parametrize("config,module", [("qwen3-1.7b", "qwen3"),
                                           ("deepseek-v2-lite-16b", "deepseek_v2")])
def test_reference_logits_equal_the_ports_forward(config, module):
    import importlib

    from rag_bench.harness.weights import make_params
    from rag_bench.reference.common import Precision
    from repro_torch.models import lm

    mc, view = tiny(config)
    ref = importlib.import_module(f"rag_bench.reference.{module}")
    params = make_params(torch, lm.init_params(mc, device="meta"), 2**33 + 7, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, mc.vocab_size, 40))
    want = lm.forward(params, mc, toks[None])[0]
    got = ref.logits_at(params, view, toks, torch.arange(40), Precision("f32"))
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), float((got - want).abs().max())
    # the control's precision moves the logits by far more than rounding
    low = ref.logits_at(params, view, toks, torch.arange(40), Precision("fp8"))
    assert float((low - want).abs().max()) > 100 * float((got - want).abs().max())


def test_yarn_runs_only_at_factor_one():
    """The deepseek file states the published YaRN group at factor 1, which is
    plain RoPE as the port runs it; the harness's check of the port and the
    reference both refuse the published factor."""
    from rag_bench.harness.serve import check_widths
    from rag_bench.reference import deepseek_v2
    from repro_torch.configs import get_config

    f = json.loads((ROOT / "rag_bench" / "configs" / "deepseek-v2-lite-16b.json").read_text())
    assert f["rope_scaling"] == dict(f["published"]["rope_scaling"], factor=1)
    mc = get_config(f["program_arch"])
    check_widths(f, mc)
    published = dict(f, rope_scaling=f["published"]["rope_scaling"])
    with pytest.raises(ValueError, match="YaRN"):
        check_widths(published, mc)
    with pytest.raises(ValueError, match="YaRN"):
        deepseek_v2.logits_at({}, published, torch.zeros(1, dtype=torch.long), torch.arange(1))


def test_exact_scan_equals_the_ports_cluster_search():
    from rag_bench.reference.ivf import partition_problems, scan_topk
    from repro_torch.retrieval import IVFIndex

    rng = np.random.default_rng(1)
    docs = rng.standard_normal((2000, 16)).astype(np.float32)
    index = IVFIndex.build(docs, 16, iters=3, device="cpu")
    assert partition_problems(index.ids, index.offsets, len(docs)) == []
    q = rng.standard_normal((1, 16)).astype(np.float32)
    for c in range(16):
        members = index.ids[index.offsets[c]: index.offsets[c + 1]]
        d, i = index.search_cluster(q, c)
        order = np.lexsort((i[0], d[0]))[:5]
        want_i, want_d = scan_topk(q[0], members, docs[members], min(5, len(members)))
        assert np.array_equal(i[0][order], want_i)
        assert np.allclose(d[0][order], want_d, rtol=1e-4, atol=1e-5)


def test_partition_problems_catch_a_lost_and_a_doubled_doc():
    from rag_bench.reference.ivf import partition_problems

    ids, offsets = np.arange(10), np.array([0, 4, 10])
    assert partition_problems(ids, offsets, 10) == []
    bad = ids.copy()
    bad[3] = 4
    assert partition_problems(bad, offsets, 10)
