"""The port's recurrent mixers against the JAX package's (f32, reduced
configs): RWKV6's chunked WKV prefill and RG-LRU's prefill scan, each also
against its own one-token decode recurrence."""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import rglru as jax_rglru  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rglru, rwkv6  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# chunked/scanned prefill against the step recurrence: the JAX package's
# own bound for the same check (test_rwkv_chunk_vs_decode_recurrence)
RECURRENCE = dict(rtol=5e-3, atol=5e-3)


def _params(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _inputs(d, S, seed, B=2):
    return (np.random.default_rng(seed).standard_normal((B, S, d)) * 0.3).astype(np.float32)


def _steps(apply, cfg, seg, p, x, state):
    outs = []
    for t in range(x.shape[1]):
        o, state = apply(cfg, seg, p, x[:, t:t + 1], mode="decode", state=state)
        outs.append(o)
    return torch.cat(outs, dim=1), state


@pytest.mark.parametrize("S", [16, 40])  # 40: a partial last chunk (chunk 16)
def test_rwkv6_prefill_matches_jax(S):
    jcfg, cfg = jax_get_config("rwkv6-1.6b").reduced(), get_config("rwkv6-1.6b").reduced()
    seg = cfg.segments[0]
    jp = jax_rwkv6.init_timemix(jcfg, jcfg.segments[0], jax.random.PRNGKey(3))
    x = _inputs(cfg.d_model, S, 4)
    jout, jst = jax_rwkv6.apply_timemix(jcfg, jcfg.segments[0], jp, jnp.asarray(x), mode="prefill")
    out, st = rwkv6.apply_timemix(cfg, seg, _params(jp), torch.from_numpy(x), mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st["S"].numpy(), np.asarray(jst["S"]), **TOL)
    np.testing.assert_array_equal(st["x_prev"].numpy(), np.asarray(jst["x_prev"]))


def test_rwkv6_chunked_prefill_matches_step_recurrence():
    cfg = get_config("rwkv6-1.6b").reduced()
    seg = cfg.segments[0]
    jp = jax_rwkv6.init_timemix(jax_get_config("rwkv6-1.6b").reduced(), seg, jax.random.PRNGKey(3))
    p = _params(jp)
    x = torch.from_numpy(_inputs(cfg.d_model, 32, 4))
    out_par, st_par = rwkv6.apply_timemix(cfg, seg, p, x, mode="prefill")
    out_seq, st_seq = _steps(rwkv6.apply_timemix, cfg, seg, p, x,
                             rwkv6.timemix_init_state(cfg, 2))
    torch.testing.assert_close(out_par, out_seq, **RECURRENCE)
    torch.testing.assert_close(st_par["S"], st_seq["S"], **RECURRENCE)


@pytest.mark.parametrize("S", [1, 2, 21])  # 1, 2: shorter than the conv tail
def test_rglru_prefill_matches_jax(S):
    jcfg, cfg = (g("recurrentgemma-2b").reduced() for g in (jax_get_config, get_config))
    seg = cfg.segments[0]
    jp = jax_rglru.init_rglru(jcfg, jcfg.segments[0], jax.random.PRNGKey(5))
    x = _inputs(cfg.d_model, S, 6)
    jout, jst = jax_rglru.apply_rglru(jcfg, jcfg.segments[0], jp, jnp.asarray(x), mode="prefill")
    out, st = rglru.apply_rglru(cfg, seg, _params(jp), torch.from_numpy(x), mode="prefill")
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(st["h"].numpy(), np.asarray(jst["h"]), **TOL)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(jst["conv"]), **TOL)


def test_rglru_scan_matches_step_recurrence():
    cfg = get_config("recurrentgemma-2b").reduced()
    seg = cfg.segments[0]
    jp = jax_rglru.init_rglru(jax_get_config("recurrentgemma-2b").reduced(), seg,
                              jax.random.PRNGKey(5))
    p = _params(jp)
    x = torch.from_numpy(_inputs(cfg.d_model, 37, 7))
    out_par, st_par = rglru.apply_rglru(cfg, seg, p, x, mode="prefill")
    out_seq, st_seq = _steps(rglru.apply_rglru, cfg, seg, p, x, rglru.rglru_init_state(cfg, 2))
    torch.testing.assert_close(out_par, out_seq, **RECURRENCE)
    torch.testing.assert_close(st_par["h"], st_seq["h"], **RECURRENCE)
    torch.testing.assert_close(st_par["conv"], st_seq["conv"], **RECURRENCE)


def test_linear_scan_equals_the_loop():
    g = torch.Generator().manual_seed(0)
    a = torch.rand((3, 45, 8), generator=g, dtype=torch.float64)
    b = torch.randn((3, 45, 8), generator=g, dtype=torch.float64)
    h, want = torch.zeros((3, 8), dtype=torch.float64), []
    for t in range(45):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, dim=1), rtol=1e-12,
                               atol=1e-12)
