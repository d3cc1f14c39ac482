"""The split arithmetic of the port's CUDA kernels, on the CPU.

``decode_attention`` splits the cache into chunks and combines per-chunk
partials (m, l, acc); ``ivf_scan`` spreads a cluster's rows over ranges and
merges their top-k lists by the (dist, row) key.  A CUDA kernel cannot run
here, so each algorithm is written once more below in plain PyTorch, as the
kernel computes it, and held against the port's plain versions and the JAX
package's Pallas kernels (interpret mode) and jnp oracles.

Inputs are drawn with numpy from a seed.  Tolerances: f32 rtol 1e-4 /
atol 1e-5, because the split forms sum in another order; ids bit for bit.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode_attention
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_attention_ref
from repro.kernels.ivf_scan.ivf_scan import ivf_scan_pallas
from repro.kernels.ivf_scan.ref import ivf_scan_ref as jax_ivf_scan_ref
from repro_torch.kernels.decode_attention import decode_attention_ref
from repro_torch.kernels.ivf_scan import ivf_scan_ref

F32 = dict(rtol=1e-4, atol=1e-5)
LOG2E = 1.0 / math.log(2.0)


# ---------------------------------------------------------------------------
# decode_attention: per-chunk partials, combined in split order
# ---------------------------------------------------------------------------


def split_decode_attention(q, k_cache, v_cache, lengths, chunk):
    """decode_attention as csrc/decode_attention.cu computes it: scores in
    base 2 (q scaled by log2(e)/sqrt(dh)), one partial (m, l, acc) per chunk
    of ``chunk`` cache rows up to ceil(length / chunk) chunks (at least one),
    then m = max m_i, l = sum l_i 2^(m_i - m), out = sum acc_i 2^(m_i - m) /
    max(l, 1e-30), where an empty partial weighs 0."""
    B, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qs = q.reshape(B, KV, G, dh).float() * (LOG2E / math.sqrt(dh))
    kf, vf = k_cache.float(), v_cache.float()
    n_split = max(1, -(-S // chunk))
    n_active = torch.clamp(-(-lengths.long() // chunk), min=1)           # (B,)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        lo, hi = s * chunk, min((s + 1) * chunk, S)
        sc = torch.einsum("bkgd,bskd->bkgs", qs, kf[:, lo:hi])          # (B, KV, G, n)
        rows = torch.arange(lo, hi)[None, :] < lengths[:, None]          # (B, n)
        sc = sc.masked_fill(~rows[:, None, None, :], -torch.inf)
        m = sc.amax(-1)                                                  # (B, KV, G)
        p = torch.where(rows[:, None, None, :],
                        torch.exp2(sc - torch.where(torch.isinf(m), 0.0, m)[..., None]), 0.0)
        active = (s < n_active)[:, None, None]
        ms.append(torch.where(active, m, -torch.inf))
        ls.append(torch.where(active, p.sum(-1), 0.0))
        accs.append(torch.where(active[..., None],
                                torch.einsum("bkgs,bskd->bkgd", p, vf[:, lo:hi]), 0.0))
    M = torch.stack(ms).amax(0)
    L = torch.zeros_like(M)
    A = torch.zeros_like(accs[0])
    for m, l, acc in zip(ms, ls, accs):   # split order
        w = torch.where(torch.isinf(m), 0.0, torch.exp2(m - torch.where(torch.isinf(M), 0.0, M)))
        L = L + l * w
        A = A + acc * w[..., None]
    out = A / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, H, dh).to(q.dtype)


S_ATTN, KV_ATTN, DH_ATTN, SB_ATTN = 384, 2, 32, 128
# lengths at and around the edges of every chunk size tested, 1 and S
ATTN_LENGTHS = np.array([1, 2, 6, 7, 8, 31, 32, 33, 255, 256, 257, 383, 384], np.int32)
_attn_refs: dict = {}


def _attn_case(G):
    """Inputs for G query heads a kv head, and the JAX package's oracle and
    Pallas kernel (interpret mode) on them; computed once per G."""
    if G not in _attn_refs:
        rng = np.random.default_rng(100 + G)
        B, H = len(ATTN_LENGTHS), KV_ATTN * G
        q = rng.standard_normal((B, H, DH_ATTN)).astype(np.float32)
        k = (rng.standard_normal((B, S_ATTN, KV_ATTN, DH_ATTN)) * 0.3).astype(np.float32)
        v = rng.standard_normal((B, S_ATTN, KV_ATTN, DH_ATTN)).astype(np.float32)
        args = tuple(map(jnp.asarray, (q, k, v, ATTN_LENGTHS)))
        oracle = np.asarray(jax_decode_attention_ref(*args))
        pallas = np.asarray(jax_decode_attention(*args, impl="interpret", sb=SB_ATTN))
        _attn_refs[G] = (q, k, v, oracle, pallas)
    return _attn_refs[G]


@pytest.mark.parametrize("G", [1, 2, 10])
@pytest.mark.parametrize("chunk", [1, 7, 32, 256, S_ATTN + 5])
def test_split_decode_attention_matches_plain_pallas_and_oracle(chunk, G):
    q, k, v, oracle, pallas = _attn_case(G)
    lengths = torch.from_numpy(ATTN_LENGTHS)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = split_decode_attention(qt, kt, vt, lengths, chunk).numpy()
    np.testing.assert_allclose(out, decode_attention_ref(qt, kt, vt, lengths).numpy(), **F32)
    np.testing.assert_allclose(out, oracle, **F32)
    np.testing.assert_allclose(out, pallas, **F32)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_split_decode_attention_length_zero_gives_zeros(chunk):
    """A length of 0: zeros, as the TPU kernel's acc / max(l, 1e-30) gives
    (the oracles give NaN there), and never 2^(-inf - -inf)."""
    rng = np.random.default_rng(7)
    B, H, KV, dh, S = 3, 4, 2, 16, 64
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, KV, dh)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, KV, dh)).astype(np.float32))
    lengths = torch.tensor([0, chunk, S], dtype=torch.int32)
    out = split_decode_attention(q, k, v, lengths, chunk)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1:], decode_attention_ref(q[1:], k[1:], v[1:], lengths[1:]),
                               **F32)


# ---------------------------------------------------------------------------
# ivf_scan: the plain version per row range, merged in split order
# ---------------------------------------------------------------------------


def split_ivf_scan(q_groups, group_cluster, slab, valid, k, span):
    """ivf_scan as csrc/ivf_scan.cu computes it: the top-k of each range of
    ``span`` rows (``ivf_scan_ref`` on that range), then the ranges' lists
    merged in split order by the key (dist, row).  Concatenating in split
    order and sorting stably by distance is that merge: within a list equal
    distances are in row order, and split order is row order."""
    L = slab.shape[1]
    ds, ids = [], []
    for lo in range(0, L, span):
        hi = min(lo + span, L)
        d_r, i_r = ivf_scan_ref(q_groups, group_cluster, slab[:, lo:hi].contiguous(),
                                (valid - lo).clamp(0, hi - lo).to(torch.int32), min(k, hi - lo))
        ds.append(d_r)
        ids.append(torch.where(i_r >= 0, i_r + lo, -1))
    d, order = torch.sort(torch.cat(ds, -1), dim=-1, stable=True)
    i = torch.gather(torch.cat(ids, -1), -1, order)
    d, i = d[..., :k], i[..., :k]
    return d, torch.where(torch.isfinite(d), i, -1).to(torch.int32)


IVF_L, IVF_LB = 256, 128


def _ivf_valid(span):
    """valid of 0, 1 and L, and at and around the first split edges."""
    edges = [span - 1, span, span + 1, 2 * span, 2 * span + 1]
    return np.array([0, 1, IVF_L] + [min(max(e, 0), IVF_L) for e in edges], np.int32)


def _jax_ivf(q, gc, slab, valid, k):
    args = tuple(map(jnp.asarray, (q, gc, slab, valid)))
    oracle = tuple(map(np.asarray, jax_ivf_scan_ref(*args, k)))
    pallas = tuple(map(np.asarray, ivf_scan_pallas(*args, k, lb=IVF_LB, interpret=True)))
    return oracle, pallas


def _assert_same_topk(want, got_d, got_i, filled_only=False):
    """Distances within F32, ids bit for bit; with ``filled_only`` the ids
    only where the distance is finite: the Pallas kernel's unfilled slots
    carry an arbitrary id, where the oracle and the port put -1."""
    wd, wi = want
    fin = np.isfinite(wd)
    assert np.array_equal(fin, np.isfinite(got_d))
    np.testing.assert_allclose(got_d[fin], wd[fin], **F32)
    assert np.array_equal(got_i[fin], wi[fin]) if filled_only else np.array_equal(got_i, wi)


@pytest.mark.parametrize("span", [1, 7, 32, 100, IVF_L])
def test_split_ivf_scan_matches_plain_pallas_and_oracle(span):
    rng = np.random.default_rng(span)
    valid = _ivf_valid(span)
    C = G = len(valid)
    QB, d, k = 8, 32, 10
    q = rng.standard_normal((G, QB, d)).astype(np.float32)
    slab = rng.standard_normal((C, IVF_L, d)).astype(np.float32)
    gc = rng.permutation(C).astype(np.int32)
    sd, si = split_ivf_scan(*map(torch.from_numpy, (q, gc, slab, valid)), k, span)
    sd, si = sd.numpy(), si.numpy()
    pd, pi = ivf_scan_ref(*map(torch.from_numpy, (q, gc, slab, valid)), k)
    _assert_same_topk((pd.numpy(), pi.numpy()), sd, si)
    oracle, pallas = _jax_ivf(q, gc, slab, valid, k)
    _assert_same_topk(oracle, sd, si)
    _assert_same_topk(pallas, sd, si, filled_only=True)
    # an empty cluster is (+inf, -1) throughout; valid 1 keeps only row 0
    empty, one = gc.tolist().index(0), gc.tolist().index(1)
    assert np.all(np.isinf(sd[empty])) and np.all(si[empty] == -1)
    assert np.all(si[one, :, 0] == 0) and np.all(si[one, :, 1:] == -1)


@pytest.mark.parametrize("span", [4, 7, 32])
def test_split_ivf_scan_ties_straddling_a_split_edge_go_to_the_lower_row(span):
    """Identical rows on both sides of a split edge, nearer the query than
    any other row: they fill the top-k in row order.  The values are small
    integers, so every distance is exact and the ties are exact ties."""
    rng = np.random.default_rng(span)
    QB, d, k = 8, 16, 6
    q = np.zeros((2, QB, d), np.float32)
    slab = rng.integers(3, 6, size=(2, IVF_L, d)).astype(np.float32)
    tie = np.arange(span - 3, span + 3)
    slab[:, tie] = 1.0
    slab[1, span - 3] = 2.0   # cluster 1: one tied row fewer, one row past the edge wins
    valid = np.array([IVF_L, IVF_L], np.int32)
    gc = np.array([0, 1], np.int32)
    sd, si = split_ivf_scan(*map(torch.from_numpy, (q, gc, slab, valid)), k, span)
    sd, si = sd.numpy(), si.numpy()
    assert np.array_equal(si[0], np.broadcast_to(tie, (QB, k)))
    assert np.all(sd[0] == d)
    assert np.array_equal(si[1, :, :5], np.broadcast_to(tie[1:], (QB, 5)))
    pd, pi = ivf_scan_ref(*map(torch.from_numpy, (q, gc, slab, valid)), k)
    _assert_same_topk((pd.numpy(), pi.numpy()), sd, si)
    oracle, pallas = _jax_ivf(q, gc, slab, valid, k)
    _assert_same_topk(oracle, sd, si)
    _assert_same_topk(pallas, sd, si, filled_only=True)
