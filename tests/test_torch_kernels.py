"""The port's kernel wrappers on CPU tensors (their plain PyTorch versions)
against the JAX package's Pallas kernels in interpret mode and its jnp
oracles, on the cases of ``tests/test_kernels.py``.

Inputs are drawn with numpy from a seed and handed to both frameworks.
Tolerances: f32 is held to rtol 1e-4 / atol 1e-5, as ``test_kernels.py``
holds its f32 cases; each looser bf16 bound says why next to it.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_attention_ref
from repro.kernels.ivf_scan.ivf_scan import ivf_scan_pallas
from repro.kernels.ivf_scan.ref import ivf_scan_ref as jax_ivf_scan_ref
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.ivf_scan import ivf_scan

F32 = dict(rtol=1e-4, atol=1e-5)


def _ivf_case(rng, G, QB, d, C, L):
    q = rng.standard_normal((G, QB, d)).astype(np.float32)
    slab = rng.standard_normal((C, L, d)).astype(np.float32)
    valid = rng.integers(1, L + 1, size=(C,)).astype(np.int32)
    gc = rng.integers(0, C, size=(G,)).astype(np.int32)
    return q, gc, slab, valid


def _port_ivf(q, gc, slab, valid, k, dtype=torch.float32):
    n0 = ivf_scan.plain_calls
    d, i = ivf_scan(torch.from_numpy(q).to(dtype), torch.from_numpy(gc),
                    torch.from_numpy(slab).to(dtype), torch.from_numpy(valid), k)
    assert ivf_scan.plain_calls == n0 + 1  # a CPU tensor takes the plain version
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def _assert_same_topk(dr, ir, dp, ip, tol):
    fin = np.isfinite(dr)
    assert np.array_equal(fin, np.isfinite(dp))
    np.testing.assert_allclose(dr[fin], dp[fin], **tol)
    assert np.array_equal(ir, ip)


@pytest.mark.parametrize("G,QB,d,C,L,k,lb", [
    (2, 8, 32, 4, 512, 5, 256),
    (4, 8, 64, 6, 1024, 10, 512),
    (1, 16, 128, 3, 256, 20, 128),
    (3, 8, 48, 5, 384, 1, 128),
])
def test_ivf_scan_plain_matches_pallas_and_oracle(G, QB, d, C, L, k, lb):
    q, gc, slab, valid = _ivf_case(np.random.default_rng(G * 100 + k), G, QB, d, C, L)
    dt, it = _port_ivf(q, gc, slab, valid, k)
    dp, ip = map(np.asarray, ivf_scan_pallas(jnp.asarray(q), jnp.asarray(gc), jnp.asarray(slab),
                                             jnp.asarray(valid), k, lb=lb, interpret=True))
    dr, ir = map(np.asarray, jax_ivf_scan_ref(jnp.asarray(q), jnp.asarray(gc),
                                              jnp.asarray(slab), jnp.asarray(valid), k))
    _assert_same_topk(dr, ir, dt, it, F32)
    _assert_same_topk(dp, ip, dt, it, F32)


def test_ivf_scan_plain_pads_short_clusters():
    """A cluster with fewer valid rows than k: (+inf, -1) in the tail, as the
    JAX oracle gives (never the TPU kernel's internal 3e38 sentinel)."""
    rng = np.random.default_rng(3)
    q, _, slab, _ = _ivf_case(rng, 2, 8, 32, 2, 256)
    valid = np.array([3, 0], np.int32)
    gc = np.array([0, 1], np.int32)
    dt, it = _port_ivf(q, gc, slab, valid, 5)
    dr, ir = map(np.asarray, jax_ivf_scan_ref(jnp.asarray(q), jnp.asarray(gc),
                                              jnp.asarray(slab), jnp.asarray(valid), 5))
    _assert_same_topk(dr, ir, dt, it, F32)
    assert np.all(it[0, :, 3:] == -1) and np.all(np.isinf(dt[0, :, 3:]))
    assert np.all(it[1] == -1) and np.all(np.isinf(dt[1]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ivf_scan_plain_dtypes(dtype):
    rng = np.random.default_rng(0)
    G, QB, d, C, L, k = 2, 8, 64, 4, 512, 8
    q, gc, slab, valid = _ivf_case(rng, G, QB, d, C, L)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    dt, it = _port_ivf(q, gc, slab, valid, k, tdt)
    args = (jnp.asarray(q, jdt), jnp.asarray(gc), jnp.asarray(slab, jdt), jnp.asarray(valid))
    dr, ir = map(np.asarray, jax_ivf_scan_ref(*args, k))
    dp, _ = map(np.asarray, ivf_scan_pallas(*args, k, lb=256, interpret=True))
    # Both sides round the same f32 draws to bf16 (round to nearest even) and
    # widen them to f32, so only summation order differs: the f32 bound
    # holds against the oracle for either dtype.  Against the Pallas kernel
    # the bf16 bound is test_kernels.py's own 5e-2 (its MXU dot rounds).
    _assert_same_topk(dr, ir, dt, it, F32)
    tol = F32 if dtype == "float32" else dict(rtol=5e-2, atol=5e-2)
    fin = np.isfinite(dr)
    np.testing.assert_allclose(dp[fin], dt[fin], **tol)


def test_ivf_scan_plain_duplicate_distances():
    """All rows identical: the lower row wins every tie, as in the Pallas
    kernel's k-pass selection."""
    G, QB, d, C, L, k = 1, 8, 16, 1, 256, 4
    q = np.zeros((G, QB, d), np.float32)
    slab = np.ones((C, L, d), np.float32)
    valid = np.array([L], np.int32)
    gc = np.array([0], np.int32)
    _, it = _port_ivf(q, gc, slab, valid, k)
    _, ip = ivf_scan_pallas(jnp.asarray(q), jnp.asarray(gc), jnp.asarray(slab),
                            jnp.asarray(valid), k, lb=128, interpret=True)
    assert np.array_equal(it, np.asarray(ip))
    assert np.array_equal(it[0, 0], np.arange(k))


def _attn_case(rng, B, H, KV, dh, S):
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = (rng.standard_normal((B, S, KV, dh)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    return q, k, v


def _port_attn(q, k, v, lengths, dtype=torch.float32):
    n0 = decode_attention.plain_calls
    out = decode_attention(torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
                           torch.from_numpy(v).to(dtype), torch.from_numpy(lengths))
    assert decode_attention.plain_calls == n0 + 1
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


def _jax_attn(q, k, v, lengths, sb, dtype=jnp.float32):
    args = (jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
            jnp.asarray(lengths))
    ref = np.asarray(jax_decode_attention_ref(*args).astype(jnp.float32))
    pal = np.asarray(jax_decode_attention(*args, impl="interpret", sb=sb).astype(jnp.float32))
    return ref, pal


@pytest.mark.parametrize("B,H,KV,dh,S,sb", [
    (2, 8, 4, 64, 512, 256),
    (2, 16, 8, 128, 1024, 512),
    (1, 10, 1, 256, 512, 128),   # MQA, G = 10
    (2, 32, 32, 96, 256, 256),   # MHA, odd head dim
])
def test_decode_attention_plain_matches_pallas_and_oracle(B, H, KV, dh, S, sb):
    rng = np.random.default_rng(B * 10 + H)
    q, k, v = _attn_case(rng, B, H, KV, dh, S)
    lengths = rng.integers(1, S + 1, size=(B,)).astype(np.int32)
    out = _port_attn(q, k, v, lengths)
    ref, pal = _jax_attn(q, k, v, lengths, sb)
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, pal, **F32)


def test_decode_attention_plain_bf16():
    rng = np.random.default_rng(5)
    B, H, KV, dh, S = 2, 8, 4, 64, 512
    q, k, v = _attn_case(rng, B, H, KV, dh, S)
    lengths = np.array([S, S // 2], np.int32)
    out = _port_attn(q, k, v, lengths, torch.bfloat16)
    ref, pal = _jax_attn(q, k, v, lengths, 256, jnp.bfloat16)
    # Against the oracle: the same bf16 inputs, an f32 computation on both
    # sides, then one rounding to bf16; two f32 results that differ in their
    # last bits may round one bf16 step (2^-8 relative) apart: 1e-2.
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    # Against the Pallas kernel: test_kernels.py's own bf16 bound (3e-2).
    np.testing.assert_allclose(out, pal, rtol=3e-2, atol=3e-2)


def test_decode_attention_plain_length_one():
    B, H, KV, dh, S = 2, 4, 4, 64, 256
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dh)).astype(np.float32)
    lengths = np.array([1, S], np.int32)
    out = _port_attn(q, k, v, lengths)
    ref, pal = _jax_attn(q, k, v, lengths, 128)
    np.testing.assert_allclose(out, ref, **F32)
    np.testing.assert_allclose(out, pal, **F32)
    np.testing.assert_allclose(out[0], np.repeat(v[0, 0], H // KV, axis=0), **F32)


def test_wrappers_refuse_bad_inputs():
    q = torch.zeros((1, 8, 16))
    slab = torch.zeros((2, 32, 16))
    valid = torch.tensor([32, 32], dtype=torch.int32)
    with pytest.raises(ValueError):   # group_cluster must be int32
        ivf_scan(q, torch.tensor([0]), slab, valid, 4)
    with pytest.raises(ValueError):   # width mismatch
        ivf_scan(q, torch.tensor([0], dtype=torch.int32), slab[..., :8], valid, 4)
    with pytest.raises(TypeError):    # float16 is not taken
        ivf_scan(q.half(), torch.tensor([0], dtype=torch.int32), slab.half(), valid, 4)
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError):   # lengths must be int32
        decode_attention(torch.zeros((1, 4, 16)), kv, kv, torch.ones(1, dtype=torch.int64))
    with pytest.raises(TypeError):    # q and the cache must share a dtype
        decode_attention(torch.zeros((1, 4, 16)).bfloat16(), kv, kv,
                         torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):   # H must be a multiple of KV
        decode_attention(torch.zeros((1, 3, 16)), kv, kv, torch.ones(1, dtype=torch.int32))
