"""Every model family of the JAX package in the port, on the reduced
configs (f32): the parameter tree, prefill and decode logits, ``cache_len``
and every decode-state leaf against the JAX package, and decode against the
port's own full forward pass.

The JAX parameters from ``lm.init_params(cfg, PRNGKey(0))`` go through
``params_from_numpy``, so both sides run the same weights.  Logits are f32
on both sides; rtol 1e-4 / atol 1e-4 allows for summation order (over
d_model, d_ff, the experts' top-k, RWKV's chunk einsums and RG-LRU's scan
tree, which the port runs as a doubling scan).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


def _models(arch, **overrides):
    jcfg = jax_get_config(arch).reduced(**overrides)
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = get_config(arch).reduced(**overrides)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _extras(cfg, B, rng):
    """prefix_embeds (VLM) and enc_embeds (enc-dec), as numpy."""
    out = {}
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model))
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return {k: v.astype(np.float32) for k, v in out.items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_tree_matches_jax(arch):
    """The port's own init draws the JAX package's tree: the same names,
    shapes and dtypes, and the same constants (norm scales, biases, mixes)."""
    jcfg = jax_get_config(arch).reduced()
    jtree = dict(_leaves(jax.eval_shape(lambda: jax_lm.init_params(jcfg, jax.random.PRNGKey(0)))))
    jvals = dict(_leaves(jax_lm.init_params(jcfg, jax.random.PRNGKey(0))))
    tree = dict(_leaves(lm.init_params(get_config(arch).reduced(), seed=0, device="cpu")))
    assert sorted(tree) == sorted(jtree)
    for name, t in tree.items():
        assert tuple(t.shape) == tuple(jtree[name].shape), name
        assert str(t.dtype).split(".")[1] == str(jtree[name].dtype), name
        j = np.asarray(jvals[name])
        if np.all(j == j.flat[0]):  # a constant in the JAX init
            assert torch.all(t == float(j.flat[0])), name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_and_state_match_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    rng = np.random.default_rng(0)
    # 16 prompt tokens: a multiple of recurrentgemma's reduced window (16),
    # where the JAX package's ring prefill is right (see test_torch_kvcache)
    B, S, max_len, steps = 2, 16, 40, 6
    tokens = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    extra = _extras(cfg, B, rng)
    # jitted: op-by-op JAX dispatch over recurrentgemma's 17 segments is slow
    jprefill = jax.jit(lambda p, t, **kw: jax_lm.prefill(p, jcfg, t, max_len=max_len, **kw))
    jdecode = jax.jit(lambda p, t, s: jax_lm.decode_step(p, jcfg, t, s))
    jl, jst = jprefill(jparams, jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extra.items()})
    tl, tst = lm.prefill(params, cfg, torch.from_numpy(tokens), max_len=max_len,
                         **{k: torch.from_numpy(v) for k, v in extra.items()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tst["cache_len"].numpy(), np.asarray(jst["cache_len"]))
    assert int(tst["cache_len"][0]) == S + cfg.n_prefix_embeds
    for step in range(steps):
        nxt = rng.integers(1, cfg.vocab_size, size=(B,)).astype(np.int32)
        jl, jst = jdecode(jparams, jnp.asarray(nxt), jst)
        tl, tst = lm.decode_step(params, cfg, torch.from_numpy(nxt), tst)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{arch}: decode step {step}")
    np.testing.assert_array_equal(tst["cache_len"].numpy(), np.asarray(jst["cache_len"]))
    jleaves, tleaves = dict(_leaves(jst["segments"])), dict(_leaves(tst["segments"]))
    assert sorted(tleaves) == sorted(jleaves)
    for name, t in tleaves.items():
        np.testing.assert_allclose(t.float().numpy(), np.asarray(jleaves[name], np.float32),
                                   **TOL, err_msg=f"{arch}: state {name}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_own_forward(arch):
    """Teacher-forced decode equals the port's full forward pass at every
    position, from a 21-token prompt (not a multiple of any window)."""
    _, _, cfg, params = _models(arch)
    rng = np.random.default_rng(2)
    B, P, extra = 2, 21, 5
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(B, P + extra)))
    kw = {k: torch.from_numpy(v) for k, v in _extras(cfg, B, rng).items()}
    ref = lm.forward(params, cfg, tokens, **kw)
    logits, state = lm.prefill(params, cfg, tokens[:, :P], max_len=P + extra + cfg.n_prefix_embeds,
                               **kw)
    torch.testing.assert_close(logits, ref[:, P - 1], **TOL)
    for i in range(extra):
        logits, state = lm.decode_step(params, cfg, tokens[:, P + i].to(torch.int32), state)
        torch.testing.assert_close(logits, ref[:, P + i], **TOL, msg=f"{arch}: step {i}")


def test_moe_with_binding_capacity_matches_jax():
    """deepseek's MoE at capacity_factor 1.0: tokens are dropped to the
    overflow row, and the logits still match the JAX package."""
    from repro_torch.models import layers

    jcfg, jparams, cfg, params = _models("deepseek-v2-lite-16b", capacity_factor=1.0)
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, cfg.vocab_size, size=(4, 24)).astype(np.int32)
    # the routing of the MoE layer's input: some choices overflow
    h = torch.randn((4 * 24, cfg.d_model), generator=torch.Generator().manual_seed(0))
    moe = params["segments"][1]["ffn"]
    _, _, slot, C = layers.moe_route(cfg, moe["router"][0], h)
    assert C == layers.moe_capacity(cfg, 4 * 24) and C < 4 * 24
    assert int((slot == cfg.n_experts * C).sum()) > 0
    dropped = []
    route = layers.moe_route

    def spy(cfg_, router, xt):
        out = route(cfg_, router, xt)
        dropped.append(int((out[2] == cfg_.n_experts * out[3]).sum()))
        return out

    layers.moe_route = spy
    try:
        tl = lm.forward(params, cfg, torch.from_numpy(tokens))
    finally:
        layers.moe_route = route
    assert dropped and dropped[0] > 0
    h, _, _ = jax_lm._forward(jcfg, jparams, jnp.asarray(tokens), mode="train")
    jl = (h @ jax_lm._head_weights(jcfg, jparams)).astype(jnp.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
