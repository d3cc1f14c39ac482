"""The port's KV-cache variants against the JAX package (f32, reduced
configs): the int8 cache (per-(token, kv head) scales, int8 codes, logits)
and the local ring window, which the port also holds against its own full
forward pass at prompt lengths that the JAX package gets wrong."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import Segment, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(make_cfg):
    jcfg, cfg = make_cfg(jax_get_config), make_cfg(get_config)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _run_both(jcfg, jparams, cfg, params, tokens, P, max_len):
    """Prefill tokens[:, :P] on both sides, then teacher-forced decode of the
    rest; yields (JAX logits, port logits, JAX state, port state) per call."""
    jl, jst = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens[:, :P]), max_len=max_len)
    tl, tst = lm.prefill(params, cfg, torch.from_numpy(tokens[:, :P]), max_len=max_len)
    yield np.asarray(jl), tl.numpy(), jst, tst
    decode = jax.jit(lambda p, t, s: jax_lm.decode_step(p, jcfg, t, s))
    for i in range(P, tokens.shape[1]):
        jl, jst = decode(jparams, jnp.asarray(tokens[:, i]), jst)
        tl, tst = lm.decode_step(params, cfg, torch.from_numpy(tokens[:, i]), tst)
        yield np.asarray(jl), tl.numpy(), jst, tst


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------


def _int8(get):
    return dataclasses.replace(get("qwen3-1.7b").reduced(), kv_cache_dtype="int8")


def test_int8_cache_matches_jax():
    jcfg, jparams, cfg, params = _pair(_int8)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, 22)).astype(np.int32)
    for jl, tl, jst, tst in _run_both(jcfg, jparams, cfg, params, tokens, 16, 30):
        np.testing.assert_allclose(tl, jl, atol=1e-3, rtol=0)
        for seg, jseg in zip(tst["segments"], jst["segments"]):
            st, jsm = seg["mixer"], jseg["mixer"]
            assert st["k"].dtype == torch.int8 and st["k_scale"].dtype == torch.float32
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(st[name].numpy(), np.asarray(jsm[name]), rtol=1e-5,
                                           atol=0)
            for name in ("k", "v"):
                # f32 summation order may move a value across a rounding edge
                diff = np.abs(st[name].numpy().astype(np.int32) - np.asarray(jsm[name], np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name


def test_int8_cache_tracks_the_full_precision_cache():
    """The JAX package's own criterion (tests/test_models.py): cosine > 0.999
    and the same argmax at every decode step, here on the port alone."""
    cfg = get_config("qwen3-1.7b").reduced()
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    params = lm.init_params(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, cfg.vocab_size, size=(2, 20)))
    lf, sf = lm.prefill(params, cfg, tokens[:, :16], max_len=22)
    lq, sq = lm.prefill(params, cfg8, tokens[:, :16], max_len=22)
    assert sq["segments"][0]["mixer"]["k"].dtype == torch.int8
    for i in range(16, 20):
        lf, sf = lm.decode_step(params, cfg, tokens[:, i].int(), sf)
        lq, sq = lm.decode_step(params, cfg8, tokens[:, i].int(), sq)
        cos = float((lf * lq).sum() / (lf.norm() * lq.norm()))
        assert cos > 0.999, f"step {i}: cosine {cos}"
        assert torch.equal(lf.argmax(-1), lq.argmax(-1))


# ---------------------------------------------------------------------------
# the local ring window
# ---------------------------------------------------------------------------


def _ring(get):
    """recurrentgemma's local attention alone (its RG-LRU layers dropped):
    two local_attn + GeGLU layers over a ring of window 16."""
    base = get("recurrentgemma-2b").reduced()
    return dataclasses.replace(base, n_layers=2,
                               segments=(Segment(mixer="local_attn", ffn="geglu", repeat=2),))


@pytest.mark.parametrize("P", [16, 32])
def test_ring_window_matches_jax(P):
    jcfg, jparams, cfg, params = _pair(_ring)
    assert cfg.local_window == 16
    rng = np.random.default_rng(P)
    tokens = rng.integers(1, cfg.vocab_size, size=(2, P + 20)).astype(np.int32)
    for jl, tl, jst, tst in _run_both(jcfg, jparams, cfg, params, tokens, P, P + 24):
        np.testing.assert_allclose(tl, jl, **TOL)
    ring = tst["segments"][0]["mixer"]["k"]
    assert ring.shape[2] == cfg.local_window
    np.testing.assert_allclose(ring.numpy(), np.asarray(jst["segments"][0]["mixer"]["k"]), **TOL)


# Lengths 10 and 20 are not multiples of the window: there the JAX package's
# prefill left-pads the last window keys from slot 0 while its decode writes
# slot cache_len % window, so its decode attends to padding (ROADMAP.md,
# known differences).  The port puts position p at slot p % window.
@pytest.mark.parametrize("P", [10, 16, 20, 32])
def test_ring_window_decode_matches_own_forward(P):
    _, _, cfg, params = _pair(_ring)
    rng = np.random.default_rng(100 + P)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, P + 20)))
    ref = lm.forward(params, cfg, tokens)
    logits, state = lm.prefill(params, cfg, tokens[:, :P], max_len=P + 24)
    torch.testing.assert_close(logits, ref[:, P - 1], **TOL)
    for i in range(P, P + 20):  # past the window's wrap
        logits, state = lm.decode_step(params, cfg, tokens[:, i].int(), state)
        torch.testing.assert_close(logits, ref[:, i], **TOL, msg=f"position {i}")
