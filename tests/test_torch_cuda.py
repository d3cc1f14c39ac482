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
from repro_torch.kernels.topk_merge import topk_merge, topk_merge_ref

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


def _check_ivf(q, gc, slab, valid, k, tol, span=None):
    dk, ik = ivf_scan(q, gc, slab, valid, k, _span=span)
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


def _attn_inputs(rng, B, H, KV, dh, S, dtype, dev):
    q = torch.as_tensor(rng.standard_normal((B, H, dh)), dtype=torch.float32, device=dev)
    k = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=dev) * 0.3
    v = torch.as_tensor(rng.standard_normal((B, S, KV, dh)), dtype=torch.float32, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("chunk", [1, 7, 32, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_forced_splits(cuda, chunk, dtype):
    """Small forced chunks; lengths 1, S, and at and around chunk edges."""
    B, H, KV, dh, S = 8, 20, 2, 64, 300   # G = 10: two head groups a kv head
    q, k, v = _attn_inputs(np.random.default_rng(chunk), B, H, KV, dh, S, dtype, cuda)
    lengths = torch.tensor([1, S, chunk, chunk + 1, max(1, chunk - 1), 2 * chunk, 3 * chunk + 1,
                            S - 1], dtype=torch.int32, device=cuda).clamp(1, S)
    out = decode_attention(q, k, v, lengths, _chunk=chunk)
    torch.cuda.synchronize()
    tol = F32 if dtype == torch.float32 else ATTN_BF16
    torch.testing.assert_close(out.float(), decode_attention_ref(q, k, v, lengths).float(), **tol)


@pytest.mark.parametrize("chunk", [None, 7])
def test_decode_attention_kernel_length_zero_gives_zeros(cuda, chunk):
    q, k, v = _attn_inputs(np.random.default_rng(3), 2, 4, 2, 64, 64, torch.float32, cuda)
    lengths = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths, _chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(out[1:], decode_attention_ref(q[1:], k[1:], v[1:], lengths[1:]),
                               **F32)


# the log-sum-exp output: both sides compute it in f32 from the same
# inputs, the kernel in base 2 over its chunks, the plain version with
# torch.logsumexp, so only rounding in the sums differs
LSE = dict(rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 7, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_log_sum_exp(cuda, chunk, dtype):
    """The (output, log-sum-exp) pair against the plain version's, one chunk
    or split; a length of 0 gives zeros and -inf."""
    q, k, v = _attn_inputs(np.random.default_rng(5), 6, 16, 8, 128, 2048, dtype, cuda)
    lengths = torch.tensor([0, 1, 33, 517, 2047, 2048], dtype=torch.int32, device=cuda)
    out, lse = decode_attention(q, k, v, lengths, return_lse=True, _chunk=chunk)
    torch.cuda.synchronize()
    want, want_lse = decode_attention_ref(q, k, v, lengths, return_lse=True)
    tol = F32 if dtype == torch.float32 else ATTN_BF16
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert lse.shape == (6, 16) and lse.dtype == torch.float32
    assert torch.isneginf(lse[0]).all() and torch.equal(out[0], torch.zeros_like(out[0]))
    torch.testing.assert_close(lse[1:], want_lse[1:], **LSE)


@pytest.mark.parametrize("chunk", [None, 32])
def test_decode_attention_kernel_two_calls_bit_identical(cuda, chunk):
    """The partials combine in split order, whichever block finishes last."""
    q, k, v = _attn_inputs(np.random.default_rng(4), 8, 16, 8, 128, 2048, torch.bfloat16, cuda)
    lengths = torch.tensor([1, 127, 128, 129, 1057, 1500, 2047, 2048], dtype=torch.int32,
                           device=cuda)
    outs = [decode_attention(q, k, v, lengths, _chunk=chunk).view(torch.int16) for _ in range(3)]
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("span,L", [(1, 32), (5, 150), (16, 500), (64, 1280)])
def test_ivf_scan_kernel_forced_splits(cuda, span, L):
    """Small forced spans; valid 0, 1, L and at and around split edges."""
    rng = np.random.default_rng(span)
    valid = [0, 1, L, span - 1, span, span + 1, 2 * span, 2 * span + 1]
    C = G = len(valid)
    q, _, slab, _ = _ivf_inputs(rng, G, 8, 256, C, L, torch.float32, cuda)
    valid = torch.tensor(valid, dtype=torch.int32, device=cuda).clamp(0, L)
    gc = torch.as_tensor(rng.permutation(C), dtype=torch.int32, device=cuda)
    _check_ivf(q, gc, slab, valid, min(10, L), F32, span=span)


@pytest.mark.parametrize("span", [4, 7, 32])
def test_ivf_scan_kernel_ties_across_a_split_edge_go_to_the_lower_row(cuda, span):
    """Identical rows on both sides of a split edge, nearer than any other
    row (small integers: the distances are exact, so the ties are exact)."""
    rng = np.random.default_rng(span)
    QB, d, L, k = 8, 64, 128, 6   # span 4: 32 ranges, the most the kernel takes
    slab = torch.as_tensor(rng.integers(3, 6, size=(2, L, d)), dtype=torch.float32, device=cuda)
    tie = torch.arange(span - 3, span + 3, device=cuda)
    slab[:, tie] = 1.0
    q = torch.zeros((2, QB, d), device=cuda)
    valid = torch.tensor([L, 0], dtype=torch.int32, device=cuda)
    gc = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    dk, ik = ivf_scan(q, gc, slab, valid, k, _span=span)
    torch.cuda.synchronize()
    assert torch.equal(ik[0], tie.int().expand(QB, k))
    assert torch.all(dk[0] == float(d))
    assert torch.all(torch.isinf(dk[1])) and torch.all(ik[1] == -1)  # empty cluster


@pytest.mark.parametrize("span", [None, 32])
def test_ivf_scan_kernel_two_calls_bit_identical(cuda, span):
    rng = np.random.default_rng(6)
    q, gc, slab, valid = _ivf_inputs(rng, 17, 8, 1024, 24, 768, torch.float32, cuda)
    outs = [ivf_scan(q, gc, slab, valid, 5, _span=span) for _ in range(3)]
    torch.cuda.synchronize()
    for d, i in outs[1:]:
        assert torch.equal(d.view(torch.int32), outs[0][0].view(torch.int32))
        assert torch.equal(i, outs[0][1])


def _merge_inputs(rng, Q, k, m, id_dtype, dev):
    """Half-filled ascending scoreboards; candidates with duplicates of the
    running distances and injected NaN, -inf and +inf."""
    rd = np.sort(rng.random((Q, k)).astype(np.float32), axis=1)
    rd[:, (k + 1) // 2:] = np.inf
    cd = rng.random((Q, m)).astype(np.float32)
    dup = rng.random((Q, m)) < 0.2
    cd[dup] = np.take_along_axis(rd, rng.integers(0, k, (Q, m)), axis=1)[dup]
    bad = rng.random((Q, m)) < 0.1
    cd[bad] = rng.choice(np.float32([np.nan, -np.inf, np.inf]), size=int(bad.sum()))
    ri = rng.integers(0, 2**31 - 1, (Q, k))
    ci = rng.integers(0, 2**31 - 1, (Q, m))
    return [torch.as_tensor(a).to(dev) for a in (rd, ri.astype(id_dtype), cd, ci.astype(id_dtype))]


def _assert_merge_bits(args, chunk=None):
    dk, ik = topk_merge(*args, _chunk=chunk)
    torch.cuda.synchronize()
    dr, ir = topk_merge_ref(*args)
    assert ik.dtype == args[1].dtype
    assert torch.equal(dk.view(torch.int32), dr.view(torch.int32)) and torch.equal(ik, ir)


@pytest.mark.parametrize("Q", [1, 13, 8192])
@pytest.mark.parametrize("k,m", [(1, 1), (5, 15), (10, 1024), (24, 3), (32, 96),
                                 (33, 1), (64, 192), (128, 1024)])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_topk_merge_kernel_equals_plain(cuda, Q, k, m, id_dtype):
    """No arithmetic: distances and ids equal the plain version bit for bit."""
    _assert_merge_bits(_merge_inputs(np.random.default_rng(Q + k + m), Q, k, m, id_dtype, cuda))


@pytest.mark.parametrize("chunk,k,m", [
    (chunk, k, m) for chunk in (32, 64, 128, 256)
    for k, m in ((1, 40), (10, 30), (32, 96), (32, 1024), (64, 300), (200, 57)) if k <= chunk])
def test_topk_merge_kernel_forced_chunks(cuda, chunk, k, m):
    """Rows streamed through chunks of 32..256 keys and merged (chunk >= k)."""
    _assert_merge_bits(_merge_inputs(np.random.default_rng(chunk + k + m), 13, k, m, np.int64,
                                     cuda), chunk)


@pytest.mark.parametrize("Q,k,m", [(3, 257, 1), (5, 300, 1024), (2, 1000, 96),
                                   (2, 7000, 528), (2, 8192, 100), (4, 8, 20_000)])
def test_topk_merge_kernel_large_k_and_long_rows(cuda, Q, k, m):
    """k > 256 (the list in shared memory) up to the limit k = 8192, the
    previous kernel's largest row (2k + m = 14,528), and m = 20,000."""
    _assert_merge_bits(_merge_inputs(np.random.default_rng(k + m), Q, k, m, np.int32, cuda))


@pytest.mark.parametrize("k,m,chunk", [(10, 30, None), (32, 96, None), (32, 1024, 32),
                                       (600, 96, None)])
def test_topk_merge_kernel_two_calls_bit_identical(cuda, k, m, chunk):
    args = _merge_inputs(np.random.default_rng(9), 64, k, m, np.int64, cuda)
    outs = [topk_merge(*args, _chunk=chunk) for _ in range(3)]
    torch.cuda.synchronize()
    for d, i in outs[1:]:
        assert torch.equal(d.view(torch.int32), outs[0][0].view(torch.int32))
        assert torch.equal(i, outs[0][1])


def test_topk_merge_kernel_ties_go_to_run_and_inf_slots_keep_ids(cuda):
    run_d = torch.tensor([[0.5, 0.5, torch.inf, torch.inf]], device=cuda)
    run_i = torch.tensor([[1, 2, 3, 4]], device=cuda)
    cand_d = torch.tensor([[0.5, float("nan"), -torch.inf, 0.25]], device=cuda)
    cand_i = torch.tensor([[5, 6, 7, 8]], device=cuda)
    d, i = topk_merge(run_d, run_i, cand_d, cand_i)
    assert d.tolist() == [[0.25, 0.5, 0.5, 0.5]] and i.tolist() == [[8, 1, 2, 5]]
    d, i = topk_merge(run_d[:, 2:], run_i[:, 2:], cand_d[:, 1:3], cand_i[:, 1:3])
    assert torch.isinf(d).all() and i.tolist() == [[3, 4]]


def test_topk_merge_kernel_refuses_what_it_cannot_take(cuda):
    d = torch.zeros((2, 8), device=cuda)
    i = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    big = torch.zeros((2, 8193), device=cuda)  # k over topk_merge_max_row() = 8192
    with pytest.raises(ValueError):
        topk_merge(big, big.int(), d, i)
    with pytest.raises(ValueError):
        topk_merge(d, i, d, i, _chunk=48)
    with pytest.raises(ValueError):
        topk_merge(big[:, :33], big[:, :33].int(), d, i, _chunk=32)
    with pytest.raises(ValueError):
        topk_merge(d, i, d.t().contiguous().t(), i)
    with pytest.raises(TypeError):
        topk_merge(d.bfloat16(), i, d, i)


def test_kernels_count_launches(cuda):
    """One launch a call, the split kernels included."""
    n0 = decode_attention.launches
    q = torch.zeros((1, 2, 64), device=cuda)
    kv = torch.zeros((1, 8, 1, 64), device=cuda)
    decode_attention(q, kv, kv, torch.ones(1, dtype=torch.int32, device=cuda))
    assert decode_attention.launches == n0 + 1
    decode_attention(q, kv, kv, torch.full((1,), 8, dtype=torch.int32, device=cuda), _chunk=2)
    assert decode_attention.launches == n0 + 2
    i0 = ivf_scan.launches
    args = _ivf_inputs(np.random.default_rng(0), 3, 8, 64, 2, 256, torch.float32, cuda)
    ivf_scan(*args, 4, _span=16)
    ivf_scan(*args, 4)
    assert ivf_scan.launches == i0 + 2
    m0 = topk_merge.launches
    d = torch.zeros((3, 4), device=cuda)
    topk_merge(d, d.long(), d, d.long())
    assert topk_merge.launches == m0 + 1


def test_launcher_wallclock_replay_check_on_the_card(cuda, tmp_path, capsys):
    """The launcher's wall-clock path on the card: the decode kernel
    launches, and the replay on a fresh stack is bit-identical."""
    from repro_torch.launch import serve

    a0 = decode_attention.launches
    m = serve.main(["--wallclock", "--closed-loop", "2", "--n-requests", "4", "--max-new", "6",
                    "--replay-check", "--cache-update-interval", "1", "--cache-transit", "0",
                    "--trace-out", str(tmp_path / "trace.json"),
                    "--metrics-out", str(tmp_path / "metrics.json")])
    out = capsys.readouterr().out
    assert m.finished == 4
    assert "replay-check ok" in out and "on cuda" in out
    assert decode_attention.launches > a0
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("H,KV,dh", [
    (32, 32, 96),   # phi3-mini-3.8b: MHA, 12 bf16 vectors a row
    (32, 8, 160),   # stablelm-12b: 20 bf16 vectors a row
    (10, 1, 256),   # recurrentgemma-2b (over its ring): MQA, G = 10
    (8, 1, 256),    # paligemma-3b: MQA, G = 8
    (16, 16, 64),   # whisper-medium
    (40, 8, 128),   # llama4-scout-17b-a16e: G = 5
    (64, 8, 128),   # qwen1.5-110b: G = 8
])
def test_decode_attention_kernel_bf16_family_shapes(cuda, H, KV, dh):
    """Each model family's full-width decode heads, in bf16."""
    rng = np.random.default_rng(H * 1000 + dh)
    S = 512
    q, k, v = _attn_inputs(rng, 8, H, KV, dh, S, torch.bfloat16, cuda)
    lengths = torch.tensor([1, 2, 31, 33, 100, 257, S - 1, S], dtype=torch.int32, device=cuda)
    out = decode_attention(q, k, v, lengths)
    torch.testing.assert_close(out.float(), decode_attention_ref(q, k, v, lengths).float(),
                               **ATTN_BF16)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "phi3-mini-3.8b", "stablelm-12b", "qwen1.5-110b",
                                  "recurrentgemma-2b", "rwkv6-1.6b", "whisper-medium",
                                  "deepseek-v2-lite-16b", "llama4-scout-17b-a16e",
                                  "paligemma-3b"])
def test_zoo_decode_matches_forward_on_the_card(cuda, arch):
    """Each family's reduced config on the card (f32): teacher-forced decode
    (the kernel on attention caches) equals the full forward pass, from a
    prompt of 21 tokens (not a multiple of recurrentgemma's window)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(3)
    B, P, extra = 2, 21, 4
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(B, P + extra)), device=cuda)
    kw = {}
    if cfg.n_prefix_embeds:
        kw["prefix_embeds"] = torch.randn((B, cfg.n_prefix_embeds, cfg.d_model), device=cuda)
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = torch.randn((B, cfg.encoder_seq, cfg.d_model), device=cuda)
    ref = lm.forward(params, cfg, tokens, **kw)
    logits, state = lm.prefill(params, cfg, tokens[:, :P], max_len=P + extra + cfg.n_prefix_embeds,
                               **kw)
    a0 = decode_attention.launches
    for i in range(extra):
        torch.testing.assert_close(logits, ref[:, P - 1 + i], rtol=1e-4, atol=1e-4)
        logits, state = lm.decode_step(params, cfg, tokens[:, P + i].int(), state)
    torch.testing.assert_close(logits, ref[:, P + extra - 1], rtol=1e-4, atol=1e-4)
    attn_layers = sum(s.repeat for s in cfg.segments if s.mixer in ("attn", "local_attn"))
    assert decode_attention.launches - a0 == extra * attn_layers
