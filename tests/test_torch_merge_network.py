"""The sorting network of the port's CUDA ``topk_merge``, on the CPU.

``csrc/topk_merge.cu`` keys every entry of a row by (distance, position),
sorts chunks of 32*E keys (the wrapper's ``_chunk_plan``) with a bitonic
network across a warp's registers and merges each sorted chunk into the
running list; for k > 256 the same network runs over
a list in shared memory.  A CUDA kernel cannot run here,
so the algorithm is written once more below in plain PyTorch, as the kernel
computes it: the warp is a (32, E) array (lane, register), a shuffle is a
permutation of its lanes, chunks stream through the same list and merge,
and the chunk can be forced to any size the kernel takes.  It is held bit for bit against the
port's plain version and against the JAX package's Pallas kernel
(interpret mode) and jnp oracle on the inputs where those are defined: the
jnp oracle sorts -inf and NaN first, so it gets finite and +inf inputs; the
Pallas kernel repeats position 0's id in +inf slots (``ROADMAP.md`` queue
C), so it gets rows where no +inf slot is selected.

Inputs are drawn with numpy from a seed.  No arithmetic is done on a
distance, so every comparison is exact: distances bit for bit (the Pallas
kernel's by value, since its min of -0.0 and +0.0 may come out as either),
ids equal.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import jax.numpy as jnp  # noqa: E402
import torch

from repro.kernels.topk_merge.ref import topk_merge_ref as jax_topk_merge_ref
from repro.kernels.topk_merge.topk_merge import topk_merge_pallas
from repro_torch.kernels.topk_merge import topk_merge, topk_merge_ref
from repro_torch.kernels.topk_merge.ops import _CHUNKS, _chunk_plan

NREG = 256                  # the largest k the register path keeps (32 lanes x 8 keys)
PAD = torch.iinfo(torch.int64).max
H100_SMS = 132


# ---------------------------------------------------------------------------
# the kernel's algorithm in plain PyTorch
# ---------------------------------------------------------------------------


def make_keys(d: torch.Tensor) -> torch.Tensor:
    """The kernel's 64-bit keys order_key(d) << 32 | position, less 2^63 so
    that int64 order is the kernel's unsigned order (PAD stays above all).
    order_key: non-finite -> +inf, -0 -> +0, then the IEEE bits with the
    sign flipped (positive) or all bits flipped (negative)."""
    d = torch.where(torch.isfinite(d), d, torch.inf)
    u = d.view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    ok = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return ((ok - 2**31) << 32) | torch.arange(d.shape[1])


def net_step(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """One compare-exchange step over the warp's (Q, 32, E) keys, element
    i = lane*E + r against i ^ stride: in-lane registers for stride < E,
    else register r of lane ^ (stride / E) (``__shfl_xor_sync``).  The lower
    of a pair keeps the smaller key where (i & size) == 0."""
    E = x.shape[2]
    lane = torch.arange(32)[:, None]
    r = torch.arange(E)[None, :]
    asc = ((lane * E + r) & size) == 0
    if stride < E:
        y = x[:, :, torch.arange(E) ^ stride]
        lower = (r & stride) == 0
    else:
        lm = stride // E
        y = x[:, torch.arange(32) ^ lm, :]
        lower = (lane & lm) == 0
    keep_min = lower == asc
    return torch.where(keep_min == (y < x), y, x)


def sort_net(x: torch.Tensor) -> torch.Tensor:
    log_n = (32 * x.shape[2]).bit_length() - 1
    for ls in range(1, log_n + 1):
        for lt in range(ls - 1, -1, -1):
            x = net_step(x, 1 << ls, 1 << lt)
    return x


def merge_net(best: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """best <- the N smallest of best and x, both sorted: element i takes
    min(best[i], x[N-1-i]) (register E-1-r of lane 31 - lane), then the
    clean-up steps, ascending everywhere."""
    y = x.flip(2)[:, torch.arange(32) ^ 31, :]
    best = torch.minimum(best, y)
    for lt in range((32 * x.shape[2]).bit_length() - 2, -1, -1):
        best = net_step(best, 0, 1 << lt)
    return best


def warp_select(keys: torch.Tensor, N: int) -> torch.Tensor:
    """The register path over one row block of keys (Q, n): chunks of N
    keys, entry base + r*32 + lane loaded into register r of lane; returns
    the sorted list as (Q, N) in element order."""
    Q, n = keys.shape
    E = N // 32
    best = None
    for base in range(0, n, N):
        chunk = torch.full((Q, N), PAD, dtype=torch.int64)
        part = keys[:, base:base + N]
        chunk[:, :part.shape[1]] = part
        x = sort_net(chunk.reshape(Q, E, 32).transpose(1, 2))   # (Q, lane, register)
        best = x if best is None else merge_net(best, x)
    return best.reshape(Q, N)


def block_step(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """The shared-memory path's step: the pair (i, i | stride), i with bit
    ``stride`` clear, swapped where it is out of order for (i & size) == 0."""
    i = torch.arange(x.shape[1])
    i = i[(i & stride) == 0]
    j = i | stride
    a, b = x[:, i], x[:, j]
    swap = (b < a) == ((i & size) == 0)
    x = x.clone()
    x[:, i] = torch.where(swap, b, a)
    x[:, j] = torch.where(swap, a, b)
    return x


def block_select(keys: torch.Tensor, kp: int) -> torch.Tensor:
    """The shared-memory path: a list and chunks of kp keys each."""
    Q, n = keys.shape
    lst = None
    for base in range(0, n, kp):
        x = torch.full((Q, kp), PAD, dtype=torch.int64)
        part = keys[:, base:base + kp]
        x[:, :part.shape[1]] = part
        size = 2
        while size <= kp:
            stride = size // 2
            while stride:
                x = block_step(x, size, stride)
                stride //= 2
            size *= 2
        if lst is None:
            lst = x
            continue
        lst = torch.minimum(lst, x.flip(1))
        stride = kp // 2
        while stride:
            lst = block_step(lst, 0, stride)
            stride //= 2
    return lst


def network_topk_merge(rd, ri, cd, ci, chunk=None):
    """``topk_merge`` as the CUDA kernel computes it (numpy in and out)."""
    rd, ri, cd, ci = map(torch.from_numpy, (rd, ri, cd, ci))
    Q, k = rd.shape
    d = torch.cat([rd, cd], dim=1)
    ids = torch.cat([ri, ci], dim=1)
    keys = make_keys(d)
    if k > NREG:
        kp = 1 << (k - 1).bit_length()
        lst = block_select(keys, kp)
    else:
        lst = warp_select(keys, chunk or _chunk_plan(Q, k, d.shape[1] - k, H100_SMS))
    pos = (lst[:, :k] & 0xFFFFFFFF).long()    # the low word: the position
    dd = torch.gather(d, 1, pos)              # the input value, not the decoded key
    out_d = torch.where(torch.isfinite(dd), dd, torch.inf)
    return out_d.numpy(), torch.gather(ids, 1, pos).numpy()


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

KS = [1, 5, 10, 31, 32, 33, 64]
MS = [1, 30, 96, 1024]


def make_case(seed, Q, k, m, *, special=True, half=True, sorted_cand=False, zeros=True):
    """Scoreboards (half filled with +inf when ``half``) and candidates that
    repeat running distances; ``special`` injects NaN / -inf / +inf into the
    candidates, ``zeros`` -0.0 and +0.0 into both lists."""
    rng = np.random.default_rng(seed)
    rd = np.sort(rng.random((Q, k)).astype(np.float32), axis=1)
    if half:
        rd[:, (k + 1) // 2:] = np.inf
    cd = rng.random((Q, m)).astype(np.float32)
    dup = rng.random((Q, m)) < 0.2
    cd[dup] = np.take_along_axis(rd, rng.integers(0, k, (Q, m)), axis=1)[dup]
    if zeros:
        rd[:, 0] = rng.choice(np.float32([0.0, -0.0]), size=Q)
        z = rng.random((Q, m)) < 0.05
        cd[z] = rng.choice(np.float32([0.0, -0.0]), size=int(z.sum()))
    if special:
        bad = rng.random((Q, m)) < 0.1
        cd[bad] = rng.choice(np.float32([np.nan, -np.inf, np.inf]), size=int(bad.sum()))
    if sorted_cand:
        cd = np.sort(cd, axis=1)
    ri = rng.integers(0, 2**31 - 1, (Q, k)).astype(np.int32)
    ci = rng.integers(0, 2**31 - 1, (Q, m)).astype(np.int32)
    return rd, ri, cd, ci


def assert_bits(d, i, d_ref, i_ref):
    np.testing.assert_array_equal(np.asarray(d).view(np.int32), np.asarray(d_ref).view(np.int32))
    np.testing.assert_array_equal(i, i_ref)


def port_plain(rd, ri, cd, ci):
    d, i = topk_merge_ref(*map(torch.from_numpy, (rd, ri, cd, ci)))
    return d.numpy(), i.numpy()


def pallas(rd, ri, cd, ci):
    return map(np.asarray, topk_merge_pallas(*map(jnp.asarray, (rd, ri, cd, ci)),
                                             qb=8, interpret=True))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
def test_network_equals_port_plain(k, m, order):
    """Every forced chunk that holds k, and the default one, with NaN,
    -inf, +inf, -0.0/+0.0, duplicates and half-filled boards."""
    args = make_case(1000 * k + m, 6, k, m, sorted_cand=order == "sorted")
    want = port_plain(*args)
    for chunk in [None] + [c for c in _CHUNKS if c >= k]:
        assert_bits(*network_topk_merge(*args, chunk=chunk), *want)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
def test_network_equals_pallas(k, m):
    """Full boards of finite distances, so no +inf slot is selected; the
    candidates still carry NaN / -inf / +inf and -0.0 / +0.0."""
    rd, ri, cd, ci = make_case(2000 * k + m, 8, k, m, half=False)
    dp, ip = pallas(rd, ri, cd, ci)
    for chunk in (None, 256):   # K'-key chunks, and one holding the row
        dn, in_ = network_topk_merge(rd, ri, cd, ci, chunk=chunk)
        np.testing.assert_array_equal(dn, dp)   # by value: -0.0 == +0.0
        np.testing.assert_array_equal(in_, ip)
        assert np.isfinite(dn).all()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("m", MS)
def test_network_equals_jnp_oracle(k, m):
    """Finite and +inf inputs (``lax.top_k`` on -d sorts -inf and NaN first),
    half-filled boards, ties across the two lists."""
    rd, ri, cd, ci = make_case(3000 * k + m, 8, k, m, special=False, zeros=False)
    cd[:, 1::7] = np.inf
    dj, ij = map(np.asarray, jax_topk_merge_ref(*map(jnp.asarray, (rd, ri, cd, ci))))
    for chunk in (None, 256):   # K'-key chunks, and one holding the row
        assert_bits(*network_topk_merge(rd, ri, cd, ci, chunk=chunk), dj, ij)


@pytest.mark.parametrize("k,m", [(257, 1), (300, 30), (300, 1024), (600, 96)])
def test_shared_memory_path_equals_port_plain(k, m):
    """k > 256: the list and its chunks in shared memory (K' = 512 or 1024)."""
    args = make_case(4000 + k + m, 3, k, m)
    assert_bits(*network_topk_merge(*args), *port_plain(*args))


@pytest.mark.parametrize("chunk", [32, 64])
def test_ties_across_chunk_edges_go_to_the_lower_position(chunk):
    """Identical smallest distances on both sides of a chunk edge: ids in
    position order, whatever chunk they were loaded in."""
    k, m = 8, 3 * chunk
    rd = np.full((2, k), 0.75, np.float32)
    ri = np.arange(k, dtype=np.int32)[None].repeat(2, 0)
    cd = np.full((2, m), 0.9, np.float32)
    edge = np.arange(chunk - k - 3, chunk - k + 3)      # entries chunk-3 .. chunk+2
    cd[:, edge] = 0.25
    ci = np.arange(100, 100 + m, dtype=np.int32)[None].repeat(2, 0)
    d, i = network_topk_merge(rd, ri, cd, ci, chunk=chunk)
    assert_bits(d, i, *port_plain(rd, ri, cd, ci))
    np.testing.assert_array_equal(i[0, :6], 100 + edge)
    np.testing.assert_array_equal(i[0, 6:], [0, 1])


def test_negative_zero_keeps_its_bits_and_ties_with_positive_zero():
    rd = np.float32([[-0.0, 0.0, 0.5]])
    ri = np.int32([[1, 2, 3]])
    cd = np.float32([[0.0, -0.0, -0.0]])
    ci = np.int32([[4, 5, 6]])
    d, i = network_topk_merge(rd, ri, cd, ci)
    np.testing.assert_array_equal(i, [[1, 2, 4]])
    np.testing.assert_array_equal(np.signbit(d), [[True, False, False]])
    assert_bits(d, i, *port_plain(rd, ri, cd, ci))


def test_non_finite_slots_keep_ids_in_position_order():
    """NaN and -inf count as +inf; the +inf slots take the non-finite
    entries' ids in position order (queue C: unlike the Pallas kernel)."""
    rd = np.float32([[0.5, np.inf, np.nan, np.inf]])
    ri = np.int32([[1, 2, 3, 4]])
    cd = np.float32([[-np.inf, 0.25, np.nan]])
    ci = np.int32([[5, 6, 7]])
    for chunk in (None, 32):
        d, i = network_topk_merge(rd, ri, cd, ci, chunk=chunk)
        np.testing.assert_array_equal(d, np.float32([[0.25, 0.5, np.inf, np.inf]]))
        np.testing.assert_array_equal(i, [[6, 1, 2, 3]])


@pytest.mark.parametrize("Q,k,m,chunk", [
    (16, 10, 30, 64),        # the sharded search: one chunk holds the row
    (16, 10, 1024, 256),     # a long row: the largest chunk
    (1, 1, 1, 32),
    (528, 32, 96, 128),      # 4 rows an SM at most: still the whole row
    (529, 32, 96, 32),       # more: chunks of K' = 32 (pod scale)
    (8192, 32, 96, 32),
    (8192, 33, 96, 64),
    (8192, 1, 1024, 32),
    (8192, 200, 1024, 256),
])
def test_chunk_plan(Q, k, m, chunk):
    """The wrapper's chunk on an H100: the row's length rounded up (to 256)
    while rows fit one block an SM, else K' = k rounded up to a power of
    two, at least 32; never below k."""
    assert _chunk_plan(Q, k, m, H100_SMS) == chunk


def test_wrapper_on_cpu_ignores_chunk_and_takes_the_plain_version():
    args = make_case(5, 4, 10, 30)
    n0 = topk_merge.plain_calls
    d, i = topk_merge(*map(torch.from_numpy, args), _chunk=32)
    assert topk_merge.plain_calls == n0 + 1
    assert_bits(d.numpy(), i.numpy(), *port_plain(*args))
