"""Train mode of every model family of the port against the JAX package's,
on the reduced configs (f32) with attention query chunks and loss chunks of
8 over 24 tokens (the reduced configs' chunks of 32 would cover a test's
sequence at once; recurrentgemma's third chunk also meets its window of
16).  Both sides run the same weights: the port's seeded init, handed to
JAX as numpy in the JAX tree (``test_torch_zoo`` holds the two trees'
names, shapes and dtypes equal, and ``test_torch_training`` converts the
other way); the JAX init's eager random ops would cost ~8 s for rwkv6
alone.

- ``train_loss`` for every arch of ``ARCH_IDS``: rtol 1e-5 (f32; summation
  order only).  The batch masks labels (-1), paligemma's prefix positions
  carry no loss, whisper's encoder runs on ``enc_embeds``.  recurrentgemma
  is cut to its first period, one RG-LRU and one local attention layer:
  JAX compiles its 17 reduced segments' loss in ~5 s and their gradient in
  ~14 s.
- The gradient of every parameter leaf for qwen3 (dense GQA), deepseek (MLA
  + MoE: the gradient reaches the router through the gate probabilities),
  rwkv6, recurrentgemma, paligemma and whisper: rtol 1e-4, atol 1e-6 (an
  entry that is zero up to f32 rounding carries no relative precision).
- qwen3 and deepseek with ``remat=True``: the same numbers as without
  (every layer and every loss chunk recomputed in backward).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402
from repro_torch.training.train_step import value_and_grad  # noqa: E402
from repro_torch.training.tree import leaves_with_paths  # noqa: E402

GRAD_ARCHS = ("qwen3-1.7b", "deepseek-v2-lite-16b", "rwkv6-1.6b", "recurrentgemma-2b",
              "paligemma-3b", "whisper-medium")
LOSS = dict(rtol=1e-5, atol=0)
GRAD = dict(rtol=1e-4, atol=1e-6)
# recurrentgemma cut to its first period (segments of the reduced config)
CUT = {"recurrentgemma-2b": 2}
CHUNKS = dict(attn_q_chunk=8, loss_chunk=8)


def _batch(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(t, -1, 1)
    labels[:, -1] = -1
    labels[0, 3] = -1
    b = {"tokens": t, "labels": labels}
    if cfg.n_prefix_embeds:
        b["prefix_embeds"] = rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model))
    if cfg.is_encoder_decoder:
        b["enc_embeds"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype == np.float64 else v for k, v in b.items()}


def _small(base):
    """The tests' overrides of ``base.reduced()``."""
    if base.name not in CUT:
        return dict(CHUNKS)
    segs = base.reduced().segments[:CUT[base.name]]
    return dict(CHUNKS, segments=segs, n_layers=sum(s.repeat for s in segs))


def _to_jax(tree):
    """The port's parameter tree as the JAX package's pytree (segments are
    tuples there)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return tuple(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


class _Zoo:
    """Per arch, once per module: the port's parameters, a batch, and JAX's
    loss on the same weights (and for GRAD_ARCHS its gradient), jitted:
    op-by-op dispatch of the recurrent scans is slow."""

    def __init__(self):
        self._memo = {}

    def __call__(self, arch):
        if arch not in self._memo:
            jcfg = jax_get_config(arch).reduced(**_small(jax_get_config(arch)))
            cfg = get_config(arch).reduced(**_small(get_config(arch)))
            params = lm.init_params(cfg, seed=0, device="cpu")
            batch = _batch(cfg)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            loss_fn = lambda p, b: jax_lm.train_loss(p, jcfg, b)  # noqa: E731
            if arch in GRAD_ARCHS:
                jl, jg = jax.jit(jax.value_and_grad(loss_fn))(_to_jax(params), jb)
                jg = {k: np.asarray(v) for k, v in leaves_with_paths(jax.tree.map(np.asarray, jg))}
            else:
                jl, jg = jax.jit(loss_fn)(_to_jax(params), jb), None
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            self._memo[arch] = (cfg, params, tb, float(jl), jg)
        return self._memo[arch]


@pytest.fixture(scope="module")
def zoo():
    return _Zoo()


def test_check_mode_accepts_train():
    for mode in layers.MODES:
        layers.check_mode(mode)
    assert "train" in layers.MODES
    with pytest.raises(ValueError):
        layers.check_mode("training")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_loss_matches_jax(zoo, arch):
    cfg, params, tb, jl, _ = zoo(arch)
    tl = lm.train_loss(params, cfg, tb)
    assert tl.dtype == torch.float32 and tl.shape == ()
    np.testing.assert_allclose(float(tl), jl, **LOSS)
    # the loss is the mean cross-entropy of the port's own forward logits
    # over the unmasked labels
    logits = lm.forward(params, cfg, tb["tokens"], **{k: v for k, v in tb.items()
                                                      if k.endswith("_embeds")})
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                           tb["labels"].long().reshape(-1), ignore_index=-1)
    np.testing.assert_allclose(float(tl), float(ce), rtol=1e-5)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_jax(zoo, arch):
    cfg, params, tb, jl, jg = zoo(arch)
    tl, tg = value_and_grad(cfg, params, tb)
    np.testing.assert_allclose(float(tl), jl, **LOSS)
    got = {k: v.numpy() for k, v in leaves_with_paths(tg)}
    assert sorted(got) == sorted(jg)
    for k, want in jg.items():
        assert got[k].shape == want.shape, k
        np.testing.assert_allclose(got[k], want, **GRAD, err_msg=f"{arch}: d loss / d {k}")
    assert all(not p.requires_grad for _, p in leaves_with_paths(params))


def test_stacked_layers_get_their_own_gradient_rows():
    """A segment of 2 stacked layers has the gradient of the same 2 layers
    as 2 segments of one: each layer's gradient lands in its row."""
    base = get_config("qwen3-1.7b")
    seg = base.reduced().segments[0]
    stacked = base.reduced(segments=(dataclasses.replace(seg, repeat=2),), n_layers=2,
                           remat=True, **CHUNKS)
    split = base.reduced(segments=(seg, seg), n_layers=2, **CHUNKS)
    params = lm.init_params(stacked, seed=1, device="cpu")
    halves = dict(params, segments=[{k: v for k, v in _rows(params["segments"][0], i).items()}
                                    for i in range(2)])
    batch = {k: torch.from_numpy(v) for k, v in _batch(stacked).items()}
    l2, g2 = value_and_grad(stacked, params, batch)
    l1, g1 = value_and_grad(split, halves, batch)
    assert float(l1) == float(l2)
    for i in range(2):
        for (k, a), (_, b) in zip(leaves_with_paths(_rows(g2["segments"][0], i)),
                                  leaves_with_paths(g1["segments"][i])):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=f"layer {i}: {k}")
            assert bool(torch.any(a != 0)), k


def _rows(tree, i):
    """Row i of every stacked leaf, kept as a stack of one."""
    if isinstance(tree, dict):
        return {k: _rows(v, i) for k, v in tree.items()}
    return tree[i:i + 1]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_remat_gives_the_same_numbers(zoo, arch):
    """The recomputed forward routes MoE tokens as the first pass did (the
    stable sorts make the routing a function of the inputs)."""
    cfg, params, tb, jl, jg = zoo(arch)
    assert not cfg.remat
    remat = dataclasses.replace(cfg, remat=True)
    l0, g0 = value_and_grad(cfg, params, tb)
    l1, g1 = value_and_grad(remat, params, tb)
    assert float(l1) == float(l0)
    for (k, a), (_, b) in zip(leaves_with_paths(g1), leaves_with_paths(g0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
        np.testing.assert_allclose(a.numpy(), jg[k], **GRAD, err_msg=k)


def test_moe_load_balance_loss_matches_jax():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    logits = np.random.default_rng(7).standard_normal((40, cfg.n_experts)).astype(np.float32)
    want = float(jax_layers.moe_load_balance_loss(jax_get_config(cfg.name).reduced(),
                                                  jnp.asarray(logits)))
    got = layers.moe_load_balance_loss(cfg, torch.from_numpy(logits))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
