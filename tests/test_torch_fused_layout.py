"""The summation orders of the fused ``norm`` and ``qk_rope`` kernels, on the
CPU.

``csrc/norm.cu`` holds a row in the registers of a group of G lanes (G a
power of two, up to 512: a lane group, one warp, or a few warps a row) and
sums it lane by lane, then by an xor-shuffle tree over the group, then, for
a row of several warps, over the warps' partials in warp order;
``csrc/qk_rope.cu`` sums a head's squares for its qk-norm the same way over
a group of G <= 32 lanes.  A CUDA kernel cannot run here, so each order is
written once more below in plain PyTorch, addition by addition as the
kernel makes them (each an f32 add, rounded), and held against the port's
plain versions and the JAX package's functions.

Inputs are drawn with numpy from a seed.  Tolerances, as the kernels are
held on the card (``tests/test_torch_fused.py``): against the plain
versions 1 bf16 step (a LayerNorm output that cancels: 2^-16 absolute)
and rtol 1e-6 / atol 1e-6 in f32, since only the order of the sum
differs; against JAX 1 bf16 step (2 for LayerNorm, whose centring
cancels, and a LayerNorm output that cancels within 2^-16 absolute, where
the plain version too lies 4 steps from JAX at d 2048) and rtol 1e-6 /
atol 2e-6 in f32; the residual sum bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.norm import norm_ref
from repro_torch.kernels.qk_rope import rms_norm_headwise_ref

try:  # the JAX side of the comparisons needs the JAX package
    import jax.numpy as jnp
except ImportError:
    jnp = None

needs_jax = pytest.mark.skipif(jnp is None, reason="holds the port against the JAX package, "
                               "which is not installed")

MAX_THREADS = 512  # norm.cu's largest block
FILL_WARPS = 512  # rows that fill fewer warps spread over more lanes
NORM_WIDTHS = (128, 512, 2048, 3072, 8192)
HEAD_DIMS = (64, 96, 128, 160, 256)
f32 = torch.float32


def norm_layout(rows: int, d: int, dtype) -> tuple[int, int, int]:
    """(V values a 16-byte vector, NV vectors a lane at most, G lanes a row)
    as ``norm.cu``'s ``norm_layout`` picks them: the fewest lanes that hold
    the row at 4 vectors a lane (8, 16 for wider rows), then, while the rows
    fill fewer than 512 warps, twice the lanes, down to a vector a lane."""
    V = 16 // torch.empty((), dtype=dtype).element_size()
    nvec = d // V
    NV = 4 if nvec <= 4 * 32 else (8 if nvec <= 8 * MAX_THREADS else 16)
    G = 1
    while G * NV < nvec:
        G *= 2
    while G < MAX_THREADS and G < nvec and rows * G < 32 * FILL_WARPS:
        G *= 2
    NV = 4
    while NV * G < nvec:
        NV *= 2
    return V, NV, G


def lane_terms(t: torch.Tensor, G: int, per_lane: list[list[int]]) -> torch.Tensor:
    """t (rows, d) -> (rows, G, n): lane l's terms in the order it adds
    them (``per_lane[l]``, element indices), 0 where it holds fewer."""
    n = max(len(ix) for ix in per_lane)
    idx = torch.full((G, n), t.shape[1], dtype=torch.long)  # the padding column, 0
    for lane, ix in enumerate(per_lane):
        idx[lane, :len(ix)] = torch.tensor(ix, dtype=torch.long)
    return torch.cat([t, torch.zeros(t.shape[0], 1, dtype=t.dtype)], 1)[:, idx]


def group_sum(terms: torch.Tensor) -> torch.Tensor:
    """(rows, G, n) -> (rows,): each lane's terms added in order from 0, the
    xor tree over min(G, 32) lanes (o = 16 .. 1, those below G), then the
    warps' partials in warp order from 0; every lane of a warp must hold
    the same bits after the tree."""
    rows, G, n = terms.shape
    acc = torch.zeros(rows, G, dtype=f32)
    for j in range(n):
        acc = acc + terms[..., j]
    lanes = torch.arange(G)
    o = min(G, 32) // 2
    while o:
        acc = acc + acc[:, lanes ^ o]
        o //= 2
    W = min(G, 32)
    warps = acc.view(rows, G // W, W)
    assert torch.equal(warps, warps[..., :1].expand_as(warps))
    total = torch.zeros(rows, dtype=f32)
    for w in range(G // W):
        total = total + warps[:, w, 0]
    return total


def norm_as_kernel(x, scale, bias=None, *, kind, eps, delta=None):
    """``kernels.norm`` of x (rows, d) as ``csrc/norm.cu`` computes it."""
    if delta is not None:
        x = x + delta  # one add, rounded to x's dtype: the kernel's s
    rows, d = x.shape
    V, NV, G = norm_layout(rows, d, x.dtype)
    per_lane = [[c * V + j for i in range(NV) if (c := lane + i * G) < d // V for j in range(V)]
                for lane in range(G)]
    s = x.float()
    inv_d = torch.tensor(1.0, dtype=f32) / d
    eps32 = torch.tensor(eps, dtype=f32)
    if kind == "layernorm":
        mu = group_sum(lane_terms(s, G, per_lane)) * inv_d
        t = s - mu[:, None]
    else:
        t = s
    var = group_sum(lane_terms(t * t, G, per_lane)) * inv_d
    y = t * torch.rsqrt(var + eps32)[:, None] * scale.float()
    if kind == "layernorm":
        y = y + bias.float()
    y = y.to(x.dtype)
    return y if delta is None else (x, y)


def qk_norm_as_kernel(x, scale, eps=1e-6):
    """The qk-norm of heads x (..., dh) as ``csrc/qk_rope.cu`` computes it:
    lane l of a head's G lanes adds x1[lV + e]^2, then x2[lV + e]^2, for e
    = 0 .. V-1, then the xor tree over the G lanes."""
    dh = x.shape[-1]
    half = dh // 2
    V = 16 // x.element_size()
    G = 1
    while G * V < half:
        G *= 2
    assert G <= 32
    per_lane = [[i for e in range(V) if (j := lane * V + e) < half for i in (j, half + j)]
                for lane in range(G)]
    xf = x.float().reshape(-1, dh)
    total = group_sum(lane_terms(xf * xf, G, per_lane))
    mean = total * (torch.tensor(1.0, dtype=f32) / dh)
    y = xf * torch.rsqrt(mean + torch.tensor(eps, dtype=f32))[:, None] * scale.float()
    return y.to(x.dtype).reshape(x.shape), G


def _t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _steps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values apart two bf16 tensors lie, element by element."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return (ordered(a) - ordered(b)).abs()


def _within_plain(got, want, layernorm=False) -> bool:
    """The kernels' tolerance against their plain versions."""
    if got.dtype == f32:
        return bool(torch.allclose(got, want, rtol=1e-6, atol=1e-6))
    over = _steps(got, want) > 1
    return not bool(over.any()) or (
        layernorm and bool(((got.float() - want.float()).abs()[over] <= 2.0**-16).all()))


def _within_jax(got, want_np, dtype, steps, layernorm=False):
    if dtype == f32:
        np.testing.assert_allclose(got.numpy(), want_np, rtol=1e-6, atol=2e-6)
        return
    over = _steps(got, _t(want_np, dtype)) > steps
    if layernorm:  # outputs that cancel, as against the plain version
        over &= (got.float() - torch.from_numpy(want_np)).abs() > 2.0**-16
    assert not bool(over.any())


# ---------------------------------------------------------------------------
# the layout itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [8, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
@pytest.mark.parametrize("d", NORM_WIDTHS + (64, 1024, 5120, 16384, 32768))
def test_norm_layout_holds_each_vector_once(d, dtype, rows):
    """Every 16-byte vector of a row lies in exactly one lane, a lane holds
    at most NV.  A prefill's 1,024 rows: one warp holds a row of up to
    2,048 bf16 (1,024 f32) values, 8 vectors a lane at 2,048 bf16, and wider
    rows take 2-16 warps.  A decode step's 8 rows spread over up to 512
    lanes, down to one vector a lane (at 2,048 bf16: 8 warps a row)."""
    V, NV, G = norm_layout(rows, d, dtype)
    nvec = d // V
    held = sorted(lane + i * G for lane in range(G) for i in range(NV) if lane + i * G < nvec)
    assert held == list(range(nvec))
    assert G <= MAX_THREADS and (G & (G - 1)) == 0 and NV in (4, 8, 16)
    assert rows * G >= 32 * FILL_WARPS or G >= min(nvec, MAX_THREADS)  # the card is filled
    if rows == 1024:
        assert (G <= 32) == (nvec <= 8 * 32)
    if d == 2048 and dtype == torch.bfloat16:
        assert (G, NV) == ((32, 8) if rows == 1024 else (256, 4))
    if d in (3072, 8192) and dtype == torch.bfloat16 and rows == 1024:
        assert G // 32 in (2, 4)


def test_the_tree_gives_every_lane_the_same_bits():
    """a + b = b + a in f32, so the xor tree leaves one value in every lane
    of a group (``group_sum`` asserts it): here on terms of mixed signs and
    magnitudes, at every group size."""
    rng = np.random.default_rng(20)
    for G in (1, 2, 4, 8, 16, 32, 64, 512):
        t = _t(rng.standard_normal((7, G, 5)) * 10.0 ** rng.integers(-6, 6, (7, G, 5)), f32)
        assert torch.isfinite(group_sum(t)).all()


# ---------------------------------------------------------------------------
# norm: the kernel's order against the plain version and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [6, 1024])  # a decode step's layout, a prefill's
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_norm_order_within_tolerance_of_plain(d, dtype, kind, residual, rows):
    rng = np.random.default_rng(21)
    x, delta = (_t(rng.standard_normal((rows, d)), dtype) for _ in range(2))
    scale = _t(1 + 0.1 * rng.standard_normal(d), dtype)
    bias = _t(0.1 * rng.standard_normal(d), dtype) if kind == "layernorm" else None
    kw = dict(kind=kind, eps=1e-6, delta=delta if residual else None)
    got, want = norm_as_kernel(x, scale, bias, **kw), norm_ref(x, scale, bias, **kw)
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    assert _within_plain(got, want, kind == "layernorm")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
def test_norm_row_across_layouts_within_tolerance(dtype, kind):
    """Not batch-invariant: the lanes a row takes depend on the launch's
    row count (at d 2048 bf16: 8 rows 256 lanes, 504 rows 64, 512 and 1024
    rows 32; f32: 8 rows 512 lanes, the rest 64), and so does its sum's
    order.  A decode step's rows, launched
    among 504, 512 or 1,024 rows, stay within the kernels' tolerance of
    themselves launched alone (1 bf16 step, 2^-16 for a cancelling
    LayerNorm output, f32 rtol/atol 1e-6); the residual sum is the same
    bits."""
    rng = np.random.default_rng(25)
    d = 2048
    x, delta = (_t(rng.standard_normal((1024, d)), dtype) for _ in range(2))
    scale = _t(1 + 0.1 * rng.standard_normal(d), dtype)
    bias = _t(0.1 * rng.standard_normal(d), dtype) if kind == "layernorm" else None
    kw = dict(kind=kind, eps=1e-6)
    res, y = norm_as_kernel(x[:8], scale, bias, delta=delta[:8], **kw)
    layouts = {norm_layout(8, d, dtype)[2]}
    for rows in (504, 512, 1024):
        layouts.add(norm_layout(rows, d, dtype)[2])
        got = norm_as_kernel(x[:rows], scale, bias, delta=delta[:rows], **kw)
        assert torch.equal(got[0][:8], res)
        assert _within_plain(got[1][:8], y, kind == "layernorm"), rows
    assert layouts == ({256, 64, 32} if dtype == torch.bfloat16 else {512, 64})


@needs_jax
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
@pytest.mark.parametrize("d", NORM_WIDTHS)
def test_norm_order_within_tolerance_of_jax(d, dtype, kind):
    from repro.configs import get_config as jax_get_config
    from repro.models import layers as jl

    rng = np.random.default_rng(22)
    x = rng.standard_normal((5, d))
    scale, bias = 1 + 0.1 * rng.standard_normal(d), 0.1 * rng.standard_normal(d)
    jdt = jnp.float32 if dtype == f32 else jnp.bfloat16
    cfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(), norm_type=kind,
                              norm_eps=1e-5)
    jp = {"scale": jnp.asarray(scale, jnp.float32).astype(jdt)}
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias, jnp.float32).astype(jdt)
    want = np.asarray(jl.apply_norm(cfg, jp, jnp.asarray(x, jnp.float32).astype(jdt))
                      .astype(jnp.float32))
    got = norm_as_kernel(_t(x, dtype), _t(scale, dtype),
                         _t(bias, dtype) if kind == "layernorm" else None, kind=kind,
                         eps=cfg.norm_eps)
    _within_jax(got.float() if dtype == f32 else got, want, dtype, 1 + (kind == "layernorm"),
                kind == "layernorm")


# ---------------------------------------------------------------------------
# qk_rope's qk-norm: the kernel's order against the plain version and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_qk_norm_order_within_tolerance_of_plain(dh, dtype):
    """Lane groups of 4-32 lanes; dh 96 and 160 hold a head's halves in 6
    and 10 bf16 vectors (12 and 20 f32), so some lanes of the group hold
    none."""
    rng = np.random.default_rng(23)
    x = _t(rng.standard_normal((3, 5, 8, dh)), dtype)
    scale = _t(1 + 0.1 * rng.standard_normal(dh), dtype)
    got, G = qk_norm_as_kernel(x, scale)
    assert G * 16 // x.element_size() >= dh // 2 and G <= 32
    assert _within_plain(got, rms_norm_headwise_ref(x, scale))


@needs_jax
@pytest.mark.parametrize("dtype", [torch.bfloat16, f32])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_qk_norm_order_within_tolerance_of_jax(dh, dtype):
    from repro.models import layers as jl

    rng = np.random.default_rng(24)
    x, scale = rng.standard_normal((2, 7, 4, dh)), 1 + 0.1 * rng.standard_normal(dh)
    jdt = jnp.float32 if dtype == f32 else jnp.bfloat16
    want = np.asarray(jl.rms_norm_headwise(jnp.asarray(x, jnp.float32).astype(jdt),
                                           jnp.asarray(scale, jnp.float32).astype(jdt))
                      .astype(jnp.float32))
    got, _ = qk_norm_as_kernel(_t(x, dtype), _t(scale, dtype))
    _within_jax(got, want, dtype, 1)
