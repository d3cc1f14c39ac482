"""The port's dense decoder and generation engine against the JAX package's,
on the reduced qwen3-1.7b config (two layers, d_model 64, float32).

The JAX parameters from ``lm.init_params(cfg, PRNGKey(0))`` go through
``params_from_numpy``, so both sides run the same weights.  Logits are f32
end to end on both sides; the bound, rtol 1e-4 / atol 1e-4, allows for
summation order over d_model and d_ff and for the vocab-wide head product
(logits are O(1), so 1e-4 absolute is 1e-4 relative).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch

from repro.configs import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.serving.engine import GenerationEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import lm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import GenerationEngine

LOGITS = dict(rtol=1e-4, atol=1e-4)


def _cfg(get):
    base = get("qwen3-1.7b")
    seg = dataclasses.replace(base.segments[0], repeat=2)
    return base.reduced(n_layers=2, segments=(seg,))


@pytest.fixture(scope="module")
def models():
    jcfg = _cfg(jax_get_config)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = _cfg(get_config)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def test_convert_keeps_layout(models):
    jcfg, jparams, cfg, params = models
    wq = params["segments"][0]["mixer"]["wq"]
    assert wq.shape == (2, cfg.d_model, cfg.n_heads * cfg.d_head)  # (L, in, out)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jparams["segments"][0]["mixer"]["wq"]))
    assert params["embed"].dtype == torch.float32


def test_prefill_and_decode_logits_match(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(0)
    B, S, max_len, steps = 3, 20, 40, 6
    tokens = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jst = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens), max_len=max_len)
    tl, tst = lm.prefill(params, cfg, torch.from_numpy(tokens), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_array_equal(tst["cache_len"].numpy(), np.asarray(jst["cache_len"]))
    n0 = decode_attention.plain_calls
    for _ in range(steps):
        nxt = rng.integers(1, cfg.vocab_size, size=(B,)).astype(np.int32)
        jl, jst = jax_lm.decode_step(jparams, jcfg, jnp.asarray(nxt), jst)
        tl, tst = lm.decode_step(params, cfg, torch.from_numpy(nxt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    np.testing.assert_array_equal(tst["cache_len"].numpy(), np.asarray(jst["cache_len"]))
    np.testing.assert_allclose(tst["segments"][0]["mixer"]["k"].numpy(),
                               np.asarray(jst["segments"][0]["mixer"]["k"]), **LOGITS)
    # every layer of every step went through the decode-attention op
    assert decode_attention.plain_calls - n0 == steps * 2


def test_greedy_streams_identical(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 33, 9, 40)]
    kw = dict(max_batch=4, max_len=96, eos_id=0)
    jeng = JaxEngine(jcfg, jparams, **kw)
    teng = GenerationEngine(cfg, params, device="cpu", **kw)

    def serve(eng):
        pending = list(prompts)
        done, seqs = {}, {}
        while pending or eng.seqs:
            while pending and eng.can_admit():
                sid = eng.add_sequence(pending.pop(0), max_new=12)
                seqs[sid] = eng.seqs[sid]
            eng.step()
            for sid, seq in seqs.items():
                if seq.done:
                    done[sid] = list(seq.tokens)
        return done

    jout, tout = serve(jeng), serve(teng)
    assert len(tout) == len(prompts)
    assert sum(map(len, tout.values())) > 2 * len(prompts)  # decode steps ran
    assert tout == jout


def test_entry_points_take_cpu_when_asked(models):
    _, _, cfg, _ = models
    p = lm.init_params(cfg, seed=3, device="cpu")
    assert p["embed"].device.type == "cpu"
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    # scales: embed ~ 0.02, weights ~ 1/sqrt(fan_in)
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    w1 = p["segments"][0]["ffn"]["w1"]
    assert abs(float(w1.std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05
    q = lm.init_params(cfg, seed=3, device="cpu")
    assert torch.equal(p["embed"], q["embed"])  # seeded


def test_outside_dense_subset_raises():
    cfg = get_config("rwkv6-1.6b").reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lm.init_params(cfg, device="cpu")
