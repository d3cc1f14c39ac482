"""The model families behind the harness: each found by the configuration
file's ``model_type`` (``families/<model_type>.py``), none named in the
harness's code.  The numbers the cells read are pinned: model FLOPs, the
seeded weights and the ``decode_attention`` bytes, as literals the harness
gave before the families moved out of it."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import types

import numpy as np
import pytest
import torch

from conftest import ROOT

CONFIGS = ROOT / "rag_bench" / "configs"
SEED = 2**33 + 7

# ModelFlops(f): active_params, token(c) at c = 1, 700, 2048, 4096, and
# prefill(w) at w = 512, 1024, 2048
FLOPS = {
    "qwen3-1.7b": (1720451072, (3441131520.0, 3601465344.0, 3910664192.0, 4380426240.0),
                   (1791865389056.0, 3643860320256.0, 7528238809088.0)),
    "deepseek-v2-lite-16b": (2451308544,
                             (4902893568.0, 5096153088.0, 5468848128.0, 6035079168.0),
                             (2546449514496.0, 5165376602112.0, 10620663496704.0)),
}
# sha256 of make_params's tree at the tiny size on the CPU (``digest``)
WEIGHTS = {
    ("qwen3-1.7b", "bfloat16"): "b632d571d6c387b05302cc325c3ba66c1cb4738a609ecc0c89cb7f79ddb874bf",
    ("qwen3-1.7b", "float32"): "ba87719c34222d04cdc710c76e888eea6c64753bff0104c756d773720640ac72",
    ("deepseek-v2-lite-16b", "bfloat16"):
        "8bef2e20a474c7fdafeadf208cbd68fb52e3e9f463f96752553400f49babcc20",
    ("deepseek-v2-lite-16b", "float32"):
        "16e2b667802b898e0e267a09d8c42f8fd3891b96fa704daf9e11fde120ea281e",
}
# recorded attention lengths (cache_len + 1) of three decode steps, 32 slots
STEP_LENS = [np.array([1 + i, 2048 + i, 700 + i, 4096, 513 + i] * 6 + [17 + i, 3000 + i])
             for i in range(3)]


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def digest(tree) -> str:
    from rag_bench.harness.weights import _leaves

    h = hashlib.sha256()
    for path, t in _leaves(tree):
        h.update(repr((path, str(t.dtype), tuple(t.shape))).encode())
        h.update(t.float().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_model_flops_are_the_pinned_literals(name):
    from rag_bench.harness.peaks import ModelFlops

    active, tokens, prefills = FLOPS[name]
    m = ModelFlops(config(name))
    assert m.active_params == active
    assert tuple(m.token(c) for c in (1, 700, 2048, 4096)) == tokens
    assert tuple(m.prefill(w) for w in (512, 1024, 2048)) == prefills


@pytest.mark.parametrize("name,dtype", sorted(WEIGHTS))
def test_tiny_weights_are_the_pinned_draws(name, dtype):
    from rag_bench import families
    from rag_bench.harness.serve import model_config
    from rag_bench.harness.weights import make_params
    from repro_torch.models import lm

    f = config(name)
    mc = dataclasses.replace(model_config(torch, f, tiny=True), dtype=dtype)
    params = make_params(torch, lm.init_params(mc, device="meta"), SEED, torch.device("cpu"),
                         families.load(f["model_type"]).WEIGHTS)
    assert digest(params) == WEIGHTS[(name, dtype)]


def _context(mc, step_lens, launches, secs=0.0123):
    from rag_bench.harness.readings import Context
    from rag_bench.harness.serve import Window

    stack = types.SimpleNamespace(step_lens=step_lens, scan_calls=[], mc=mc, engine_batch=32,
                                  spans=types.SimpleNamespace(rows=[]))
    w = Window(t0=0.0, seconds=10.0, due={}, put={}, done={}, drained_at=10.0, timed_out=False)
    return Context(w, 1.0, stack, None, (0, 0),
                   {"kernels": {"decode_attention": (launches, secs)}})


def test_decode_attention_roofline_of_full_attention_is_the_pinned_reading():
    from rag_bench.harness.readings import reader
    from repro_torch.configs import get_config

    mc = get_config("qwen3-1.7b")
    ctx = _context(mc, STEP_LENS, 28 * 3)
    assert ctx.attn_windows == [0] * 28
    assert reader("decode_attention_roofline.online")(ctx) == 39.458209129959954


def test_a_ring_window_layer_reads_at_most_its_window():
    from rag_bench.harness.peaks import decode_attention_bytes
    from rag_bench.harness.readings import reader
    from repro_torch.configs import get_config

    lens = [1, 100, 2048, 2049, 4096]
    full = decode_attention_bytes(lens, 4, 128, 32, 5)
    ring = decode_attention_bytes(lens, 4, 128, 32, 5, window=2048)
    assert full - ring == (1 + 2048) * 4 * 128 * 2 * 2
    assert decode_attention_bytes(lens[:3], 4, 128, 32, 3, window=2048) == \
        decode_attention_bytes(lens[:3], 4, 128, 32, 3)
    # three ring layers to one full one, as a window-and-full model holds them
    q = get_config("qwen3-1.7b")
    mc = dataclasses.replace(q, local_window=2048, segments=tuple(
        dataclasses.replace(q.segments[0], mixer=m, repeat=r)
        for m, r in (("local_attn", 3), ("attn", 1))) * 7)
    ctx = _context(mc, STEP_LENS, 28 * 3)
    assert ctx.attn_windows == [2048, 2048, 2048, 0] * 7
    whole = reader("decode_attention_roofline.online")(_context(q, STEP_LENS, 28 * 3))
    assert reader("decode_attention_roofline.online")(ctx) < whole


def test_a_windowed_layer_counts_at_most_its_window():
    from rag_bench.harness.peaks import Layer, ModelFlops, _attended

    for width in (1, 7, 8, 9, 30):
        assert _attended(width, 8) == sum(min(p, 8) for p in range(1, width + 1))
        assert _attended(width, 0) == sum(range(1, width + 1))
    fam = types.SimpleNamespace(layers=lambda f: [Layer(10, 2, 3, 5, window=8),
                                                  Layer(10, 2, 3, 5)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("rag_bench.families.load", lambda model_type: fam)
        m = ModelFlops({"model_type": "x", "hidden_size": 4, "vocab_size": 6})
    assert m.active_params == 44
    assert m.token(20) == 2.0 * 44 + 2 * (2 * 8 * 8 + 2 * 20 * 8)
    assert m.prefill(20) == sum(m.token(p) for p in range(1, 21))


def test_a_family_without_a_module_is_refused_by_name():
    from rag_bench import families
    from rag_bench.harness.peaks import ModelFlops
    from rag_bench.harness.serve import check_widths, file_view, model_config
    from repro_torch.configs import get_config

    f = dict(config("qwen3-1.7b"), model_type="throwaway_family")
    mc = get_config(f["program_arch"])
    match = r"families/throwaway_family\.py"
    for call in (lambda: families.load("throwaway_family"), lambda: ModelFlops(f),
                 lambda: check_widths(f, mc), lambda: file_view(f, mc),
                 lambda: model_config(torch, f, tiny=True)):
        with pytest.raises(ValueError, match=match):
            call()
    with pytest.raises(ValueError, match=r"families/no\.such\.py"):
        families.load("no.such")


def test_a_new_family_needs_only_its_own_module(monkeypatch):
    """A module under a new name serves a file of that ``model_type`` with no
    other edit: the harness finds it by the name alone."""
    from rag_bench import families
    from rag_bench.families import qwen3
    from rag_bench.harness.peaks import ModelFlops
    from rag_bench.harness.serve import check_widths, file_view, model_config

    mod = types.ModuleType("rag_bench.families.throwaway_family")
    mod.__dict__.update({k: getattr(qwen3, k) for k in ("TINY", "WEIGHTS", "port", "tiny_view",
                                                         "layers")})
    monkeypatch.setitem(__import__("sys").modules, mod.__name__, mod)
    f = dict(config("qwen3-1.7b"), model_type="throwaway_family")
    assert families.load("throwaway_family") is mod
    mc = model_config(torch, f, tiny=False)
    check_widths(f, mc)
    assert file_view(f, mc)["num_key_value_heads"] == 8
    assert ModelFlops(f).active_params == FLOPS["qwen3-1.7b"][0]
    tiny = model_config(torch, f, tiny=True)
    assert tiny.n_kv_heads == 2 and file_view(f, tiny)["head_dim"] == tiny.d_head


def test_the_port_departing_from_the_file_is_refused():
    from rag_bench.harness.serve import check_widths
    from repro_torch.configs import get_config

    mc = get_config("deepseek-v2-lite-16b")
    f = config("deepseek-v2-lite-16b")
    check_widths(f, mc)
    with pytest.raises(ValueError, match="segments"):
        check_widths(dict(f, first_k_dense_replace=2), mc)
    with pytest.raises(ValueError, match="n_experts"):
        check_widths(dict(f, n_routed_experts=32), mc)


def test_a_leaf_without_a_rule_is_refused_by_its_path():
    from rag_bench.harness.weights import make_params

    meta = {"embed": torch.empty((8, 4), device="meta"),
            "segments": [{"ffn": {"router": torch.empty((2, 4, 6), device="meta"),
                                  "expert_bias": torch.empty((2, 6), device="meta")},
                          "mixer": {"sinks": torch.empty((2, 3), device="meta")}}]}
    with pytest.raises(ValueError, match=r"'expert_bias'"):
        make_params(torch, meta, 5, torch.device("cpu"))
    p = make_params(torch, meta, 5, torch.device("cpu"), {"expert_bias": "zero",
                                                         "sinks": "small"})
    assert not p["segments"][0]["ffn"]["expert_bias"].any()
    assert float(p["segments"][0]["mixer"]["sinks"].abs().max()) < 0.2
    with pytest.raises(ValueError, match="rule"):
        make_params(torch, meta, 5, torch.device("cpu"), {"expert_bias": "ones", "sinks": "zero"})
