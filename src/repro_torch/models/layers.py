"""Layer library: norms, positions, the attention family (GQA with optional
qkv bias and qk-norm, the local ring window, the int8 KV cache,
cross-attention, MLA) and the FFN family (SwiGLU, GeGLU, GELU MLP, RWKV
channel mix, MoE).

Conventions (as in the JAX package's ``models/layers.py``)
----------------------------------------------------------
* Parameters are plain nested dicts of tensors.  Weights keep the JAX
  layout: ``x @ W`` with ``W`` of shape ``(in, out)``.  ``init_*`` functions
  draw a segment's parameters already stacked on its leading layer axis.
* Apply functions are mode-polymorphic:

    mode='forward'  full sequence, no state (the encoder, reference logits)
    mode='train'    the same computation as 'forward', under autograd: no
                    state, nothing written in place into a parameter
    mode='prefill'  full sequence, returns a decode state
    mode='decode'   one new token per sequence, consumes + returns state
* The serving modes ('prefill', 'decode') run the model body's elementwise
  chains through the fused Hopper kernels ``kernels.norm`` (the norms, and
  the residual adds before them: the mixer's before a block's second norm,
  the FFN's before the next block's first norm or the final norm, which
  ``lm`` hands on as the norm's delta), ``kernels.qk_rope``
  (qk-norm, RoPE and decode's K/V cache write) and ``kernels.glu`` (the
  gated activation), whose wrappers take their plain versions on CPU
  tensors.  'train' (the kernels have no backward), 'forward' (the
  reference) and DTensors (the mesh paths) run the plain chains, which are
  those plain versions (``_fused``).  MLA's partial-dims RoPE and the int8
  cache's quantization stay plain.
* Prefill attention is plain PyTorch (einsum, then an f32 softmax with the
  ``-1e30`` mask).  Decode attention over a K/V cache (full, ring window,
  or int8 dequantized to the model dtype) is the Hopper kernel
  ``kernels.decode_attention`` (its plain version for CPU tensors).  MLA's
  absorbed decode and cross-attention are plain f32 einsums, as in the JAX
  package.
* Decode writes the new K/V rows (and int8 scales) into the state in place.
* Sharding annotations (``constrain``) sit at the JAX package's points;
  outside a ``use_mesh`` scope they return their input.  Under a mesh the
  parameters and activations are DTensors: MoE routes per data-parallel
  token group on each rank's own groups, and decode writes a new cache row
  only on the rank that holds its slot and attends over each rank's block
  of a sequence-sharded cache (``_sharded_decode``).
* The ring window's prefill puts position ``p`` at slot ``p % window``, the
  slot decode writes it to, so decode equals the full forward pass at every
  prompt length (the JAX package left-pads the last ``window`` keys from
  slot 0, which agrees only at multiples of ``window``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, distribute_tensor

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.distributed.act_sharding import constrain, dp_total, layout
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.glu import glu, glu_ref
from repro_torch.kernels.glu.ref import gelu
from repro_torch.kernels.norm import norm, norm_ref
from repro_torch.kernels.qk_rope import (
    apply_rope_ref,
    qk_rope,
    rms_norm_headwise_ref,
    scatter_time_ref,
)

Params = dict
f32 = torch.float32

MODES = ("forward", "train", "prefill", "decode")
STATELESS = ("forward", "train")  # full sequence, no decode state
SERVING = ("prefill", "decode")


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")


def _fused(mode: str, x) -> bool:
    """Whether an op of the body takes the fused kernels' wrappers: in the
    serving modes on plain tensors (the kernel on CUDA, its plain version
    on the CPU).  Train mode, the forward reference and DTensors take the
    plain chains, without the wrappers."""
    return mode in SERVING and not isinstance(x, DTensor)


# ---------------------------------------------------------------------------
# Parameter init (the JAX package's scales; torch.Generator draws)
# ---------------------------------------------------------------------------


class Init:
    """Draws parameters with a leading ``lead`` shape (a segment's layer
    axis) from ``gen`` on ``device``.  ``normal`` is the JAX ``_dense``:
    standard normal in f32 times ``scale`` (default ``1/sqrt(shape[0])`` of
    the per-layer shape), cast to ``dtype``.  Each layer is drawn on its
    own, so the f32 temporary is one layer's, not the segment's."""

    def __init__(self, gen: torch.Generator, device, dtype: torch.dtype, lead: tuple = ()):
        self.gen, self.device, self.dtype, self.lead = gen, device, dtype, tuple(lead)

    def _fill(self, shape, draw, dtype):
        out = torch.empty(self.lead + tuple(shape), dtype=dtype or self.dtype, device=self.device)
        flat = out.view(-1, *shape) if self.lead else out[None]
        for i in range(flat.shape[0]):
            flat[i].copy_(draw())
        return out

    def normal(self, shape, scale=None, dtype=None):
        scale = 1.0 / math.sqrt(shape[0]) if scale is None else scale
        return self._fill(shape, lambda: torch.randn(shape, generator=self.gen, dtype=f32,
                                                     device=self.device) * scale, dtype)

    def uniform(self, shape, lo, hi, dtype=None):
        return self._fill(shape, lambda: torch.rand(shape, generator=self.gen, dtype=f32,
                                                    device=self.device) * (hi - lo) + lo, dtype)

    def full(self, shape, value, dtype=None):
        return torch.full(self.lead + tuple(shape), value, dtype=dtype or self.dtype,
                          device=self.device)


def init_norm(cfg: ModelConfig, mk: Init, d: Optional[int] = None) -> Params:
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"scale": mk.full((d,), 1.0), "bias": mk.full((d,), 0.0)}
    return {"scale": mk.full((d,), 1.0)}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor, *, mode: str = "forward",
               delta=None):
    """The block's norm of x, or with ``delta`` of the residual sum x + delta:
    returns y, or (x + delta, y).  A delta of another dtype is added first
    (type promotion, as the plain chain), then normed alone."""
    if delta is not None and delta.dtype != x.dtype:
        x = x + delta
        return x, apply_norm(cfg, p, x, mode=mode)
    fn = norm if _fused(mode, x) else norm_ref
    return fn(x, p["scale"], p.get("bias"), kind=cfg.norm_type, eps=cfg.norm_eps, delta=delta)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
                      mode: str = "forward") -> torch.Tensor:
    """Per-head qk-norm (Qwen3); eps is fixed at 1e-6 as in the JAX package.
    The same arithmetic as an RMSNorm of the last dim: the serving modes run
    it as ``kernels.norm``."""
    if _fused(mode, x):
        return norm(x, scale, kind="rmsnorm", eps=eps)
    return rms_norm_headwise_ref(x, scale, eps)


# ---------------------------------------------------------------------------
# Positional embeddings (RoPE: ``kernels.qk_rope``, its plain version
# ``apply_rope_ref``)
# ---------------------------------------------------------------------------


def sinusoidal_embedding(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(..., S) -> (..., S, d) f32 transformer sinusoids: sines, then cosines."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=f32, device=positions.device)
                      / max(half - 1, 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Prefill attention (plain PyTorch)
# ---------------------------------------------------------------------------


def _per_shard(fn):
    """``fn(q, k, v, ...)`` over (B, S, heads, dh) tensors, run on each rank's
    block when q is a DTensor: attention is independent per sequence and
    per kv head, so the blocks keep the batch shards and the head shards
    that q and k share, and gather everything else (sequence, head_dim,
    partial sums).  A plain q calls ``fn`` as it is."""
    def wrapped(q, k, v, *args, **kwargs):
        if not isinstance(q, DTensor):
            return fn(q, k, v, *args, **kwargs)
        mesh = q.device_mesh
        kp = k.placements if isinstance(k, DTensor) else [Replicate()] * mesh.ndim
        pl = [p if (p.is_shard() and (p.dim == 0 or (p.dim == 2 and kp[i] == p))) else Replicate()
              for i, p in enumerate(q.placements)]
        out = fn(*(_ContiguousGrad.apply(_local(t, mesh, pl)) for t in (q, k, v)), *args,
                 **kwargs)
        return DTensor.from_local(out, mesh, pl)

    return wrapped


def split_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, whose last two dims split x's last dim into
    (heads, head_dim).  A DTensor whose last dim is sharded into more
    blocks than the heads divide (recurrentgemma's 10 heads over a model
    axis of 8) is gathered over that dim first: DTensor cannot split an
    uneven shard."""
    if isinstance(x, DTensor):
        n = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim == x.dim() - 1)
        if shape[-2] % n:
            x = x.redistribute(x.device_mesh, _without(x.placements, x.dim() - 1))
    return x.reshape(*shape)


def merge_heads(x: torch.Tensor, *shape) -> torch.Tensor:
    """``x.reshape(*shape)``, merging x's (heads, head_dim) into one dim.  On
    a DTensor the result is also a constraint to its own layout, so its
    gradient comes back laid out as the heads were: the backward of the
    merge then splits an even shard (the product after it would otherwise
    hand back a gradient sharded where the heads are not)."""
    y = x.reshape(*shape)
    return y.redistribute(y.device_mesh, y.placements) if isinstance(y, DTensor) else y


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a DTensor's
    backward views its local gradient, which a permuted einsum gradient
    does not allow."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


@_per_shard
def _sdpa_block(q, k, v, mask, scale):
    """q:(B,Sq,H,dh) k,v:(B,Sk,KV,dh) mask:(B?,Sq,Sk) or None -> (B,Sq,H,dh)."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.reshape(B, Sq, KV, G, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, -1e30)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


@_per_shard
def blocked_attention(q, k, v, *, causal: bool, window: int = 0, q_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Causal attention in query chunks, each against only the keys it may
    see (``[lo, q_offset + q1)``, ``lo`` the window's start), so the work is
    ~S^2/2 (or S * window), not S^2.

    q: (B, Sq, H, dh); k, v: (B, Sk, KV, dh).
    """
    B, Sq, H, dh = q.shape
    Sk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    if not causal:
        return _sdpa_block(q, k, v, None, scale)
    qc = min(q_chunk, Sq)
    outs = []
    for q0 in range(0, Sq, qc):
        q1 = min(q0 + qc, Sq)
        hi = min(q_offset + q1, Sk)
        lo = max(0, q_offset + q0 - window + 1) if window else 0
        qpos = q_offset + torch.arange(q0, q1, device=q.device)
        kpos = torch.arange(lo, hi, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        outs.append(_sdpa_block(q[:, q0:q1], k[:, lo:hi], v[:, lo:hi], mask[None], scale))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# Attention mixer (GQA, optional qkv bias / qk-norm, ring window, int8 KV)
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, seg: Segment, mk: Init) -> Params:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": mk.normal((d, H * dh)), "wk": mk.normal((d, KV * dh)),
         "wv": mk.normal((d, KV * dh)), "wo": mk.normal((H * dh, d))}
    if cfg.qkv_bias:
        p["bq"] = mk.full((H * dh,), 0.0)
        p["bk"] = mk.full((KV * dh,), 0.0)
        p["bv"] = mk.full((KV * dh,), 0.0)
    if cfg.qk_norm:
        p["q_norm"] = mk.full((dh,), 1.0)
        p["k_norm"] = mk.full((dh,), 1.0)
    return p


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions, *, mode: str = "forward",
         cache=None):
    """q (B, S, H, dh), k and v (B, S, KV, dh) after the bias, qk-norm and
    RoPE.  In the serving modes the norm and RoPE of q and k are one
    ``qk_rope`` call, which with ``cache`` = (k_cache, v_cache, slot) also
    writes the new K and V rows (decode)."""
    B, S, _ = x.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(split_heads(q, B, S, H, dh), "dp", None, "tp", None)
    k = constrain(split_heads(k, B, S, KV, dh), "dp", None, "tp", None)
    v = constrain(split_heads(v, B, S, KV, dh), "dp", None, "tp", None)
    rope = cfg.pos_emb == "rope" and positions is not None
    if _fused(mode, q):
        if cfg.qk_norm or rope or cache is not None:
            k_cache, v_cache, slot = cache or (None, None, None)
            q, k = qk_rope(q, k, positions, theta=cfg.rope_theta if rope else None,
                           q_scale=p["q_norm"] if cfg.qk_norm else None,
                           k_scale=p["k_norm"] if cfg.qk_norm else None,
                           v=None if cache is None else v, k_cache=k_cache, v_cache=v_cache,
                           slot=slot)
        return q, k, v
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"])
        k = rms_norm_headwise(k, p["k_norm"])
    if rope:
        q = apply_rope_ref(q, positions, cfg.rope_theta)
        k = apply_rope_ref(k, positions, cfg.rope_theta)
    return q, k, v


def attention_init_state(cfg: ModelConfig, seg: Segment, batch: int, max_len: int,
                         device=None) -> Params:
    """Decode-state skeleton (zeros) for one attention layer: a (B, max_len)
    cache, a (B, window) ring for ``local_attn``; int8 rows with a
    per-(token, kv head) f32 scale for ``kv_cache_dtype='int8'``."""
    if seg.mixer == "local_attn":
        max_len = min(max_len, cfg.local_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=f32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=f32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, KV, dh) -> (int8 values, per-(token, head) f32 scale).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  The divisor
    is a tensor on x's device: CUDA divides by a Python scalar as a product
    with its reciprocal, which can round a scale one ulp off the CPU's."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(-1) / torch.full((), 127.0, device=x.device), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dt) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dt)


def _scatter_time(cache: torch.Tensor, new: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Write new (B, 1, ...) at per-sequence time position lengths (B,).

    Updates ``cache`` IN PLACE (the JAX version returns a new array and
    relies on buffer donation for the same effect) and returns it.  Like
    ``lax.dynamic_update_slice``, a position past the end is clamped to the
    last row.  On a DTensor cache each rank writes its own block, and only
    where it holds the row.
    """
    if isinstance(cache, DTensor):
        return _scatter_time_sharded(cache, new, lengths)
    return scatter_time_ref(cache, new, lengths)


def _prefill_cache(t: torch.Tensor, rows: int, window: int) -> torch.Tensor:
    """A (B, rows, ...) cache holding prefill's t (B, S, ...): position p at
    row p, or for a ring window at row p % window (the last window ones).
    A DTensor t gives a DTensor cache laid out as t, its sequence whole
    (``distributed.sharding.decode_state_shardings`` then shards it)."""
    if isinstance(t, DTensor):
        pl = _without(t.placements, 1)
        local = _prefill_cache(t.redistribute(t.device_mesh, pl).to_local(), rows, window)
        return DTensor.from_local(local, t.device_mesh, pl)
    B, S = t.shape[:2]
    cache = torch.zeros((B, rows) + t.shape[2:], dtype=t.dtype, device=t.device)
    if window:
        pos = torch.arange(max(0, S - window), S, device=t.device)
        cache[:, pos % window] = t[:, pos]
    else:
        cache[:, :S] = t
    return cache


# ---------------------------------------------------------------------------
# Decode over a sharded cache (DTensors under a mesh)
# ---------------------------------------------------------------------------


def _without(placements, *dims) -> list:
    """``placements`` with every shard of the tensor dims ``dims``, and every
    partial sum, made whole (``Replicate``)."""
    return [Replicate() if (p.is_partial() or (p.is_shard() and p.dim in dims)) else p
            for p in placements]


def _only(placements, *dims) -> list:
    """Only the shards of tensor dims ``dims`` kept; everything else whole."""
    return [p if (p.is_shard() and p.dim in dims) else Replicate() for p in placements]


def _local(x, mesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` (a DTensor, or a plain tensor whole on
    every rank) laid out by ``placements``."""
    if isinstance(x, DTensor):
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(mesh, placements)
        return x.to_local()
    return distribute_tensor(x, mesh, placements, src_data_rank=None).to_local()


def _block(cache: DTensor) -> tuple[torch.Tensor, int]:
    """(this rank's block of a (B, S, ...) cache, the global row of its
    first row)."""
    mesh, local = cache.device_mesh, cache.to_local()
    coord = mesh.get_coordinate()
    block = 0  # the block's index: mesh dims sharding the rows, major first
    for i, p in enumerate(cache.placements):
        if p.is_shard() and p.dim == 1:
            block = block * mesh.size(i) + coord[i]
    return local, block * local.shape[1]


def _scatter_time_sharded(cache: DTensor, new, lengths) -> DTensor:
    """``_scatter_time`` on each rank's block: the rank whose rows hold
    position ``lengths[b]`` (clamped to the last row) writes it; the others
    keep theirs (a select, so no shape depends on the data)."""
    mesh, pl = cache.device_mesh, cache.placements
    loc, off = _block(cache)
    rows = loc.shape[1]
    new_l = _local(new, mesh, _without(pl, 1))[:, 0].to(loc.dtype)
    pos = _local(lengths, mesh, _only(pl, 0)).long().clamp(0, cache.shape[1] - 1) - off
    own = (pos >= 0) & (pos < rows)
    idx = pos.clamp(0, rows - 1)
    b = torch.arange(loc.shape[0], device=loc.device)
    keep = loc[b, idx]
    loc[b, idx] = torch.where(own.view((-1,) + (1,) * (keep.dim() - 1)), new_l, keep)
    return cache


def _sharded_decode(q, k_cache: DTensor, v_cache: DTensor, lengths) -> DTensor:
    """Decode attention of q (B, 1, H, dh) over a DTensor cache (B, S, KV, dh).

    Each rank runs the kernel on its block: its batch rows, its kv heads
    (when heads are on ``model``) and its cache rows, with local lengths
    ``clamp(len - offset, 0, rows)``, and returns its output and the
    log-sum-exp of its scores.  Where the sequence is sharded, the partial
    outputs are combined over those mesh dims: out = sum_i w_i out_i /
    sum_i w_i with w_i = exp(lse_i - max lse); a block holding none of a
    sequence has lse -inf and weighs 0.
    """
    import torch.distributed._functional_collectives as funcol

    mesh, pl = k_cache.device_mesh, k_cache.placements
    dh = q.shape[-1]
    kl, off = _block(k_cache)
    vl = v_cache.to_local()
    q_pl = _without(pl, 1)
    ql = _local(q, mesh, q_pl)
    lens = (_local(lengths, mesh, _only(pl, 0)) - off).clamp(0, kl.shape[1]).to(torch.int32)
    Bl, _, Hl, _ = ql.shape
    out, lse = decode_attention(ql.reshape(Bl, Hl, dh).contiguous(), kl, vl, lens,
                                return_lse=True)
    seq_dims = [i for i, p in enumerate(pl) if p.is_shard() and p.dim == 1 and mesh.size(i) > 1]
    if seq_dims:
        m = lse
        for i in seq_dims:
            m = funcol.all_reduce(m, "max", (mesh, i))
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        w = torch.exp(lse - m)
        num = out.float() * w[..., None]
        for i in seq_dims:
            num = funcol.all_reduce(num, "sum", (mesh, i))
            w = funcol.all_reduce(w, "sum", (mesh, i))
        out = (num / w[..., None]).to(q.dtype)
    return DTensor.from_local(out.reshape(Bl, 1, Hl, dh), mesh, q_pl)


def attention_window(cfg: ModelConfig, seg: Segment) -> int:
    """A segment's attention window: ``local_window`` for ``local_attn``,
    else 0 (the whole sequence)."""
    return cfg.local_window if seg.mixer == "local_attn" else 0


def _need_eff_len(eff_len):
    if eff_len is None:
        raise ValueError("decode needs eff_len, the step's int32 attention lengths "
                         "(lm.decode_step computes them once for every layer)")
    return eff_len


def apply_attention(cfg: ModelConfig, seg: Segment, p: Params, x: torch.Tensor, *,
                    mode: str, positions: torch.Tensor, state: Optional[Params] = None,
                    cache_len: Optional[torch.Tensor] = None, max_len: int = 0, eff_len=None):
    """Returns (out, new_state).  In decode mode ``state`` is updated in place
    and ``eff_len`` is required: the step's int32 attention lengths for
    this layer's window, which ``lm.decode_step`` computes once for every
    layer."""
    check_mode(mode)
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    window = attention_window(cfg, seg)
    causal = seg.mixer != "encoder_attn"
    if mode != "decode":
        q, k, v = _qkv(cfg, p, x, positions, mode=mode)
        out = blocked_attention(q, k, v, causal=causal, window=window, q_chunk=cfg.attn_q_chunk)
        out = merge_heads(constrain(out, "dp", None, "tp", None), B, S, H * dh) @ p["wo"]
        if mode in STATELESS:
            return constrain(out, "dp", None, None), None
        rows = min(window, max_len) if window else max_len  # as attention_init_state
        st = {"k": _prefill_cache(k, rows, window), "v": _prefill_cache(v, rows, window)}
        if cfg.kv_cache_dtype == "int8":
            kq, ks = _quantize_kv(st["k"])
            vq, vs = _quantize_kv(st["v"])
            st = {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs}
        return out, st

    # decode: S == 1; the new row goes to slot cache_len (ring: % window),
    # then attention over the eff_len valid rows (>= 1)
    slot = cache_len % window if window else cache_len
    eff_len = _need_eff_len(eff_len)
    # the fused path writes the new rows of a model-dtype cache in its
    # qk_rope launch; the int8 cache is quantized and written below
    write = _fused(mode, x) and cfg.kv_cache_dtype != "int8"
    q, k, v = _qkv(cfg, p, x, positions, mode=mode,
                   cache=(state["k"], state["v"], slot) if write else None)
    if write:
        st = {"k": state["k"], "v": state["v"]}
        k_full, v_full = st["k"], st["v"]
    elif cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        st = {"k": _scatter_time(state["k"], kq, slot),
              "k_scale": _scatter_time(state["k_scale"], ks, slot),
              "v": _scatter_time(state["v"], vq, slot),
              "v_scale": _scatter_time(state["v_scale"], vs, slot)}
        k_full = _dequantize_kv(st["k"], st["k_scale"], k.dtype)
        v_full = _dequantize_kv(st["v"], st["v_scale"], v.dtype)
    else:
        st = {"k": _scatter_time(state["k"], k, slot), "v": _scatter_time(state["v"], v, slot)}
        k_full, v_full = st["k"], st["v"]
    if isinstance(k_full, DTensor):
        # the (B, 1, H*dh) product folded to 2-D by hand: on this DTensor
        # matmul would broadcast wo over the batch instead (a bmm)
        out = merge_heads(_sharded_decode(q, k_full, v_full, eff_len), B * S, H * dh)
        return (out @ p["wo"]).reshape(B, S, -1), st
    out = decode_attention(q.reshape(B, H, dh), k_full, v_full, eff_len)
    return out.reshape(B, S, H * dh) @ p["wo"], st


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder; plain, as the JAX package's _sdpa_block)
# ---------------------------------------------------------------------------


def init_cross_attention(cfg: ModelConfig, mk: Init) -> Params:
    d, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {"wq": mk.normal((d, H * dh)), "wk": mk.normal((d, KV * dh)),
            "wv": mk.normal((d, KV * dh)), "wo": mk.normal((H * dh, d))}


def apply_cross_attention(cfg: ModelConfig, p: Params, x, enc_kv):
    """enc_kv: dict with 'k','v' (B, Senc, KV, dh) precomputed from encoder."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    q = split_heads(x @ p["wq"], B, S, H, dh)
    out = _sdpa_block(q, enc_kv["k"], enc_kv["v"], None, 1.0 / math.sqrt(dh))
    return merge_heads(out, B, S, H * dh) @ p["wo"]


def encode_cross_kv(cfg: ModelConfig, p: Params, enc_out: torch.Tensor) -> Params:
    B, Se, _ = enc_out.shape
    KV, dh = cfg.n_kv_heads, cfg.d_head
    return {"k": split_heads(enc_out @ p["wk"], B, Se, KV, dh),
            "v": split_heads(enc_out @ p["wv"], B, Se, KV, dh)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


@_per_shard
def _padded_attention(q, k, v, *, q_chunk: int):
    """Causal attention with v's head dim narrower than q's and k's: v is
    padded so the blocked attention sees equal d, and the output sliced
    after (on each rank's block under a mesh)."""
    vd = v.shape[-1]
    vpad = F.pad(v, (0, q.shape[-1] - vd))
    return blocked_attention(q, k, vpad, causal=True, q_chunk=q_chunk)[..., :vd]


def init_mla(cfg: ModelConfig, seg: Segment, mk: Init) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    r, rp, np_, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_a"] = mk.normal((d, cfg.q_lora_rank))
        p["q_norm"] = mk.full((cfg.q_lora_rank,), 1.0)
        p["wq_b"] = mk.normal((cfg.q_lora_rank, H * (np_ + rp)))
    else:
        p["wq"] = mk.normal((d, H * (np_ + rp)))
    p["wkv_a"] = mk.normal((d, r + rp))
    p["kv_norm"] = mk.full((r,), 1.0)
    p["wk_b"] = mk.normal((r, H * np_))
    p["wv_b"] = mk.normal((r, H * vd))
    p["wo"] = mk.normal((H * vd, d))
    return p


def mla_init_state(cfg: ModelConfig, batch: int, max_len: int, device=None) -> Params:
    dt = dtype_of(cfg)
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt, device=device),
            "kpe": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dt, device=device)}


def _mla_q(cfg: ModelConfig, p: Params, x, positions, mode):
    B, S, _ = x.shape
    H, rp, np_ = cfg.n_heads, cfg.rope_head_dim, cfg.nope_head_dim
    if cfg.q_lora_rank:
        qa = rms_norm_headwise(x @ p["wq_a"], p["q_norm"], mode=mode)
        q = (qa @ p["wq_b"]).reshape(B, S, H, np_ + rp)
    else:
        q = (x @ p["wq"]).reshape(B, S, H, np_ + rp)
    q_nope, q_pe = q[..., :np_], q[..., np_:]
    return q_nope, apply_rope_ref(q_pe, positions, cfg.rope_theta)


def _mla_kv_latent(cfg: ModelConfig, p: Params, x, positions, mode):
    r = cfg.kv_lora_rank
    kv = x @ p["wkv_a"]
    ckv = rms_norm_headwise(kv[..., :r], p["kv_norm"], mode=mode)
    kpe = apply_rope_ref(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]
    return ckv, kpe


def apply_mla(cfg: ModelConfig, seg: Segment, p: Params, x: torch.Tensor, *, mode: str,
              positions, state=None, cache_len=None, max_len: int = 0, eff_len=None):
    check_mode(mode)
    B, S, _ = x.shape
    H = cfg.n_heads
    r, rp, np_, vd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.nope_head_dim, cfg.v_head_dim
    q_nope, q_pe = _mla_q(cfg, p, x, positions, mode)
    ckv, kpe = _mla_kv_latent(cfg, p, x, positions, mode)

    if mode != "decode":
        # expand per-head K/V from the latent (standard prefill path)
        k_nope = constrain((ckv @ p["wk_b"]).reshape(B, S, H, np_), "dp", None, "tp", None)
        v = constrain((ckv @ p["wv_b"]).reshape(B, S, H, vd), "dp", None, "tp", None)
        k = torch.cat([k_nope, kpe[:, :, None, :].expand(B, S, H, rp)], -1)
        q = constrain(torch.cat([q_nope, q_pe], -1), "dp", None, "tp", None)
        out = _padded_attention(q, k, v, q_chunk=cfg.attn_q_chunk)
        y = merge_heads(out, B, S, H * vd) @ p["wo"]
        if mode in STATELESS:
            return y, None
        return y, {"ckv": _prefill_cache(ckv, max_len, 0), "kpe": _prefill_cache(kpe, max_len, 0)}

    # decode: absorbed formulation, attention in latent space in f32 (no
    # per-head K/V).  scores = q_nope @ Wk_b^T(head) @ ckv + q_pe @ kpe
    ckv_c = _scatter_time(state["ckv"], ckv, cache_len)
    kpe_c = _scatter_time(state["kpe"], kpe, cache_len)
    wk_b = p["wk_b"].reshape(r, H, np_)
    q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), wk_b.float())  # (B,1,H,r)
    ckv_f = ckv_c.float()
    scores = torch.einsum("bshr,btr->bhst", q_lat, ckv_f)
    scores = scores + torch.einsum("bshp,btp->bhst", q_pe.float(), kpe_c.float())
    scores = scores * (1.0 / math.sqrt(np_ + rp))
    valid = torch.arange(ckv_c.shape[1], device=x.device)[None, :] < (
        _need_eff_len(eff_len)[:, None])
    scores = torch.where(valid[:, None, None, :], scores, -1e30)
    pattn = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", pattn, ckv_f)  # latent context
    wv_b = p["wv_b"].reshape(r, H, vd)
    out = torch.einsum("bshr,rhv->bshv", ctx, wv_b.float()).to(x.dtype)
    return merge_heads(out, B, S, H * vd) @ p["wo"], {"ckv": ckv_c, "kpe": kpe_c}


# ---------------------------------------------------------------------------
# FFN family
# ---------------------------------------------------------------------------


def _gated(mode: str, a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """act(a) * b, ``kind`` "silu" or "gelu" (``cfg.act``): the ``glu``
    kernel's wrapper in the serving modes, else the plain chain."""
    return (glu if _fused(mode, a) else glu_ref)(a, b, kind=kind)


def init_ffn(cfg: ModelConfig, seg: Segment, mk: Init) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    if seg.ffn in ("swiglu", "geglu"):
        return {"w1": mk.normal((d, ff)), "w3": mk.normal((d, ff)), "w2": mk.normal((ff, d))}
    if seg.ffn == "gelu_mlp":
        return {"w1": mk.normal((d, ff)), "b1": mk.full((ff,), 0.0),
                "w2": mk.normal((ff, d)), "b2": mk.full((d,), 0.0)}
    if seg.ffn == "rwkv_cmix":
        return {"mu_k": mk.full((d,), 0.5), "mu_r": mk.full((d,), 0.5),
                "wk": mk.normal((d, ff)), "wv": mk.normal((ff, d)), "wr": mk.normal((d, d))}
    if seg.ffn == "moe":
        return init_moe(cfg, mk)
    raise ValueError(seg.ffn)


def apply_ffn(cfg: ModelConfig, seg: Segment, p: Params, x, *, mode: str, state=None):
    """Returns (out, new_state); the state is rwkv_cmix's token shift (the
    last input, (B, 1, d)), else None."""
    check_mode(mode)
    if seg.ffn in ("swiglu", "geglu"):
        kind = "gelu" if seg.ffn == "geglu" else cfg.act
        h = constrain(_gated(mode, x @ p["w1"], x @ p["w3"], kind), "dp", None, "tp")
        return constrain(h @ p["w2"], "dp", None, None), None
    if seg.ffn == "gelu_mlp":
        h = constrain(gelu(x @ p["w1"] + p["b1"]), "dp", None, "tp")
        return constrain(h @ p["w2"] + p["b2"], "dp", None, None), None
    if seg.ffn == "rwkv_cmix":
        xs = state if mode == "decode" else F.pad(x, (0, 0, 1, 0))[:, :-1]
        # x and its shifted copy with the batch sharded only: DTensor may
        # shard the sequence, and the products flatten (batch, sequence)
        x, xs = constrain(x, "dp", None, None), constrain(xs, "dp", None, None)
        xk = x + (xs - x) * p["mu_k"]
        xr = x + (xs - x) * p["mu_r"]
        k = torch.square(torch.relu(xk @ p["wk"]))
        return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, -1:, :]
    if seg.ffn == "moe":
        return apply_moe(cfg, p, x, mode=mode), None
    raise ValueError(seg.ffn)


def ffn_init_state(cfg: ModelConfig, seg: Segment, batch: int, device=None):
    if seg.ffn == "rwkv_cmix":
        return torch.zeros((batch, 1, cfg.d_model), dtype=dtype_of(cfg), device=device)
    return None


# ---------------------------------------------------------------------------
# MoE: top-k routing with capacity-based dispatch per data-parallel group
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, mk: Init) -> Params:
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": mk.normal((d, E), dtype=f32), "w1": mk.normal((E, d, ff)),
         "w3": mk.normal((E, d, ff)), "w2": mk.normal((E, ff, d))}
    if cfg.n_shared_experts:
        sf = ff * cfg.n_shared_experts
        p["sw1"] = mk.normal((d, sf))
        p["sw3"] = mk.normal((d, sf))
        p["sw2"] = mk.normal((sf, d))
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to 8, as the JAX package does


def moe_route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor):
    """Routing of tokens xt (T, d): (gates (T, K) f32, experts (T, K), slot
    (T*K,) in the (E*C + 1)-row dispatch buffer, C).  Softmax in f32, then
    the top K with ties to the lower expert index (as ``lax.top_k``: a
    stable descending sort); each token's choice takes the next free row of
    its expert in token order, and choices past the capacity C go to the
    overflow row E*C."""
    E, K = cfg.n_experts, cfg.moe_top_k
    T = xt.shape[0]
    probs = torch.softmax(xt.float() @ router, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[:, :K], expert_idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    flat_e = expert_idx.reshape(T * K)
    # position within the expert: a stable sort by expert keeps token order
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=xt.device), side="left")
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(T * K, device=xt.device) - first[sorted_e]
    C = moe_capacity(cfg, T)
    slot = torch.where(pos < C, flat_e * C + pos, E * C)
    return gate_vals, expert_idx, slot, C


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              mode: str = "forward") -> torch.Tensor:
    """Top-k MoE with capacity dispatch per token group.

    Tokens are viewed as (G, T/G), G = ``dp_total()`` (1 outside a mesh, or
    where it does not divide T): routing, sort and scatter are per group,
    with capacity ``moe_capacity(cfg, T/G)``, so which tokens drop depends
    on the data-parallel pool, as in the JAX package.  A plain tensor (one
    group) takes the dispatch below; a DTensor takes ``_apply_moe_groups``.
    """
    if isinstance(x, DTensor):
        return _apply_moe_groups(cfg, p, x)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    xt = x.reshape(B * S, d)
    gate_vals, slot, buf = _dispatch(cfg, p["router"], xt)
    h = buf.view(E, -1, d)
    g = _gated(mode, torch.bmm(h, p["w1"]), torch.bmm(h, p["w3"]), cfg.act)
    y = torch.cat([torch.bmm(g, p["w2"]).reshape(-1, d), buf.new_zeros((1, d))])
    y_tok = y[slot].reshape(B * S, K, d)  # dropped choices read the zero row
    out = (y_tok * gate_vals[..., None].to(y.dtype)).sum(1)
    if cfg.n_shared_experts:
        out = out + _gated(mode, xt @ p["sw1"], xt @ p["sw3"], cfg.act) @ p["sw2"]
    return out.reshape(B, S, d)


def _dispatch(cfg: ModelConfig, router: torch.Tensor, xg: torch.Tensor):
    """One group's routing (tokens xg (Tl, d)): (gate_vals (Tl, K), slot
    (Tl*K,), the (E*C, d) dispatch buffer).  Dropped choices write the
    overflow row E*C, which is cut off: no shape depends on the data, and
    nothing waits for the device (a CUDA graph captures it)."""
    E, K = cfg.n_experts, cfg.moe_top_k
    Tl, d = xg.shape
    gate_vals, _, slot, C = moe_route(cfg, router, xg)
    buf = xg.new_zeros((E * C + 1, d))
    buf = buf.index_put((slot,), xg[:, None].expand(Tl, K, d).reshape(Tl * K, d))
    return gate_vals, slot, buf[:E * C]


def _apply_moe_groups(cfg: ModelConfig, p: Params, x: DTensor) -> DTensor:
    """``apply_moe`` on DTensors: x (B, S, d) viewed as (G, T/G, d), G over
    the data-parallel axes.  Each rank routes its own groups on its block
    (``to_local``); the G-major dispatch buffer (G, E*C, d) becomes E-major
    (E, G*C, d), experts over ``model``, in one redistribute (the JAX
    package's expert-parallel all-to-all), the experts run there, and the
    outputs come back G-major for each rank's gather by slot."""
    mesh = x.device_mesh
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.moe_top_k
    T = B * S
    G = dp_total()
    if T % G:
        G = 1
    Tl = T // G
    # every reshape of the token dims below sits between two constraints,
    # which lay out its gradient as its input (DTensor cannot view a batch
    # sharded over more mesh dims than its new leading dim divides)
    x = constrain(x, "dp", None, None)
    xt = constrain(x.reshape(G, Tl, d), "dp", None, None)
    pl = list(xt.placements)
    # the router is replicated; each rank's gradient of it is its groups'
    # share, a partial sum over the data-parallel axes
    dp_axes = ("pod", "data", "model") if layout() == "dp_only" else ("pod", "data")
    router = p["router"]
    if isinstance(router, DTensor):
        grad_pl = [Partial() if name in dp_axes else Replicate()
                   for name in mesh.mesh_dim_names]
        router = router.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
            grad_placements=grad_pl)
    xl = xt.to_local()
    routed = [_dispatch(cfg, router, xl[g]) for g in range(xl.shape[0])]
    C = moe_capacity(cfg, Tl)
    buf = DTensor.from_local(torch.stack([r[2] for r in routed]), mesh, pl)  # (G, E*C, d)
    bufe = constrain(buf.reshape(G, E, C, d).transpose(0, 1), "tp", "dp", None, None)
    h = bufe.reshape(E, G * C, d)
    g = glu_ref(torch.bmm(h, p["w1"]), torch.bmm(h, p["w3"]), kind=cfg.act)
    y = torch.bmm(g, p["w2"]).reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    yl = constrain(y, "dp", None, None).to_local()
    outs = []
    for i, (gates, slot, _) in enumerate(routed):
        yg = torch.cat([yl[i], yl.new_zeros((1, d))])  # dropped choices read the zero row
        outs.append((yg[slot].reshape(Tl, K, d) * gates[..., None].to(yg.dtype)).sum(1))
    out = DTensor.from_local(torch.stack(outs), mesh, pl)
    if cfg.n_shared_experts:
        out = out + glu_ref(xt @ p["sw1"], xt @ p["sw3"], kind=cfg.act) @ p["sw2"]
    return constrain(out.reshape(B, S, d), "dp", None, None)


def moe_load_balance_loss(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss over router logits (T, E): E times the
    dot product of each expert's share of top-1 choices and its mean
    probability (the JAX package exports it for training; its train step
    does not add it to the loss)."""
    probs = torch.softmax(logits.float(), dim=-1)
    frac_tokens = F.one_hot(probs.argmax(-1), cfg.n_experts).float().mean(0)
    return cfg.n_experts * (frac_tokens * probs.mean(0)).sum()
