"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips itself (inside the test, through the ``cuda`` fixture) when no card is
present.  On the card: ``python -m pytest -m cuda tests/test_torch_*.py``.
This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention, decode_attention_ref
from repro_torch.kernels.ivf_scan import ivf_scan, ivf_scan_ref
from repro_torch.kernels.ivf_scan.ref import topk_agreement

pytestmark = pytest.mark.cuda

# f32 kernels differ from the plain version only in summation order.
F32 = dict(rtol=1e-4, atol=1e-5)
# ivf_scan on bf16 slabs widens the same bf16 values to f32 on both sides, so
# only summation order differs; distances near 0 lose relative precision to
# cancellation in ||q||^2 - 2q.t + ||t||^2, hence the absolute 1e-4.
IVF_BF16 = dict(rtol=1e-4, atol=1e-4)
# decode_attention in bf16 rounds its f32 result to bf16 on both sides; two
# f32 values that differ in the last bits may round one bf16 step apart
# (2^-8 relative), so the bound is 1e-2.
ATTN_BF16 = dict(rtol=1e-2, atol=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ivf_inputs(rng, G, QB, d, C, L, dtype, dev):
    q = torch.as_tensor(rng.standard_normal((G, QB, d)), dtype=torch.float32).to(dtype)
    slab = torch.as_tensor(rng.standard_normal((C, L, d)), dtype=torch.float32).to(dtype)
    valid = torch.as_tensor(rng.integers(1, L + 1, size=(C,)), dtype=torch.int32)
    gc = torch.as_tensor(rng.integers(0, C, size=(G,)), dtype=torch.int32)
    return [t.to(dev) for t in (q, gc, slab, valid)]


def _check_ivf(q, gc, slab, valid, k, tol):
    dk, ik = ivf_scan(q, gc, slab, valid, k)
    torch.cuda.synchronize()
    dr, ir = ivf_scan_ref(q, gc, slab, valid, min(k + 1, slab.shape[1]))
    nxt = dr[..., k] if dr.shape[-1] > k else torch.full(dr.shape[:-1], torch.inf, device=dr.device)
    err, ties, bad = topk_agreement(dr[..., :k].cpu(), ir[..., :k].cpu(), nxt.cpu(),
                                    dk.cpu(), ik.cpu(), **tol)
    assert bad == 0, (err, ties, bad)
    return err, ties


@pytest.mark.parametrize("G,QB,d,C,L,k", [
    (2, 8, 32, 4, 512, 5),
    (4, 8, 64, 6, 1024, 10),
    (1, 16, 128, 3, 256, 20),
    (3, 8, 48, 5, 384, 1),
    (5, 3, 1024, 7, 700, 24),    # partial group, L not a multiple of any tile
    (9, 8, 1024, 16, 1280, 32),  # k at the kernel's maximum
])
def test_ivf_scan_kernel_matches_plain(cuda, G, QB, d, C, L, k):
    rng = np.random.default_rng(G * 100 + k)
    _check_ivf(*_ivf_inputs(rng, G, QB, d, C, L, torch.float32, cuda), k, F32)


@pytest.mark.parametrize("qdt,sdt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_ivf_scan_kernel_dtypes(cuda, qdt, sdt):
    rng = np.random.default_rng(0)
    q, gc, slab, valid = _ivf_inputs(rng, 6, 8, 1024, 4, 512, torch.float32, cuda)
    _check_ivf(q.to(qdt), gc, slab.to(sdt), valid, 8, IVF_BF16)


def test_ivf_scan_kernel_ties_and_empty_cluster(cuda):
    """Identical rows: ids 0..k-1 in order.  A cluster with valid 0: all
    slots come out (+inf, -1)."""
    q = torch.zeros((2, 8, 64), device=cuda)
    slab = torch.ones((2, 256, 64), device=cuda)
    valid = torch.tensor([256, 0], dtype=torch.int32, device=cuda)
    gc = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    d, i = ivf_scan(q, gc, slab, valid, 4)
    assert torch.equal(i[0].cpu(), torch.arange(4, dtype=torch.int32).expand(8, 4))
    assert torch.all(d[0] == 64.0)
    assert torch.all(torch.isinf(d[1])) and torch.all(i[1] == -1)


def test_ivf_scan_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 8, 64), device=cuda)
    slab = torch.zeros((1, 64, 64), device=cuda)
    valid = torch.tensor([64], dtype=torch.int32, device=cuda)
    gc = torch.tensor([0], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ivf_scan(q, gc, slab, valid, 33)
    with pytest.raises(ValueError):
        ivf_scan(torch.zeros((1, 17, 64), device=cuda), gc, slab, valid, 4)
    with pytest.raises(ValueError):
        ivf_scan(q[:, :, :60], gc, slab[:, :, :60], valid, 4)


@pytest.mark.parametrize("B,H,KV,dh,S", [
    (2, 8, 4, 64, 512),
    (2, 16, 8, 128, 1024),
    (1, 10, 1, 256, 512),    # MQA, G = 10
    (2, 32, 32, 96, 256),    # MHA, odd head dim
    (3, 16, 8, 128, 1000),   # S not a multiple of the tile
])
def test_decode_attention_kernel_matches_plain(cuda, B, H, KV, dh, S):
    rng = np.random.default_rng(B * 10 + H)
    q = torch.as_tensor(rng.standard_normal((B, H, dh)), dtype=torch.float32, device=cuda)
    k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=cuda) * 0.3
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=cuda)
    lengths = torch.as_tensor(rng.integers(1, S + 1, size=(B,)), dtype=torch.int32, device=cuda)
    lengths[0] = 1
    out = decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, decode_attention_ref(q, k, v, lengths), **F32)


def test_decode_attention_kernel_bf16_qwen3_shape(cuda):
    """qwen3-1.7b decode: 8 slots, 16 query heads over 8 kv heads, dh 128."""
    rng = np.random.default_rng(5)
    B, H, KV, dh, S = 8, 16, 8, 128, 2048
    q = torch.as_tensor(rng.standard_normal((B, H, dh)), device=cuda).bfloat16()
    k = (torch.as_tensor(rng.standard_normal((B, S, KV, dh)), device=cuda) * 0.3).bfloat16()
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), device=cuda).bfloat16()
    lengths = torch.tensor([1, 2, 31, 32, 33, 1000, 2047, 2048], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths)
    torch.testing.assert_close(out.float(), decode_attention_ref(q, k, v, lengths).float(),
                               **ATTN_BF16)


def test_kernels_count_launches(cuda):
    n0 = decode_attention.launches
    q = torch.zeros((1, 2, 64), device=cuda)
    kv = torch.zeros((1, 8, 1, 64), device=cuda)
    decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device=cuda))
    assert decode_attention.launches == n0 + 1
