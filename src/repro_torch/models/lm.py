"""Language model over heterogeneous layer stacks (every family of the JAX
package's ``models/lm.py``).

A model is a sequence of ``Segment`` runs (see configs.base).  Per segment
the parameters and the decode state are stacked on a leading layer axis, as
in the JAX pytree; the JAX ``lax.scan`` over a segment's layers is a Python
loop over that axis.

Entry points (functions of ``(params, cfg, ...)``, as in the JAX package):

  init_params(cfg, generator, device=...)              -> params dict
  train_loss(params, cfg, batch)                       -> scalar f32 loss
  forward(params, cfg, tokens, ...)                    -> logits (B, S, V)
  prefill(params, cfg, tokens, max_len=..., ...)       -> (last_logits, DecodeState)
  decode_step(params, cfg, tokens, state)              -> (logits, DecodeState)
  init_decode_state(cfg, batch, max_len, ...)          -> DecodeState (zeros)
  greedy(params, cfg, tokens, max_len=..., steps=...)  -> (B, steps) greedy tokens

Under ``distributed.act_sharding.use_mesh`` the same functions run on
DTensor parameters placed by ``distributed.sharding``: each layer's weights
are gathered over the data-parallel axes as it runs (``_traversal``), the
embedding lookup and the head are vocab-parallel, and prefill lays its
decode state out by the decode-state rules (the cache's sequence over
``model``).

``prefix_embeds`` (B, P, d) are prepended to the text (VLM), and
``enc_embeds`` (B, Se, d) are the encoder's input frames (enc-dec).
DecodeState = {"cache_len": (B,) i32, "segments": list[per-segment state]},
each segment's state a dict of stacked tensors: ``mixer`` (K/V cache, ring,
int8 rows and scales, MLA latents, RWKV ``S``/``x_prev``, RG-LRU
``h``/``conv``), ``ffn`` (rwkv_cmix's previous input) and ``enc_kv``.
``decode_step`` updates ``state`` in place: K/V rows are scattered into the
cache, and the recurrent states, which each step computes anew, are copied
into their slab.

``train_loss`` runs under autograd: each layer takes its parameters as views
of the stacked leaves (``unbind``), so a layer's gradient lands in its row
of the stacked leaf; with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (the JAX ``jax.checkpoint``), and the
cross-entropy is computed in ``cfg.loss_chunk`` sequence chunks, each
recomputed in the backward pass, so the (B, S, V) logits never exist whole.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, Segment
from repro_torch.device import resolve_device
from repro_torch.distributed import act_sharding
from repro_torch.models import rglru, rwkv6
from repro_torch.models.layers import (
    STATELESS,
    Init,
    _fused,
    apply_attention,
    apply_cross_attention,
    apply_ffn,
    apply_mla,
    apply_norm,
    attention_init_state,
    attention_window,
    dtype_of,
    encode_cross_kv,
    ffn_init_state,
    init_attention,
    init_cross_attention,
    init_ffn,
    init_mla,
    init_norm,
    mla_init_state,
    sinusoidal_embedding,
)


_MIXER_INIT = {
    "attn": init_attention,
    "local_attn": init_attention,
    "encoder_attn": init_attention,
    "mla": init_mla,
    "rwkv6": rwkv6.init_timemix,
    "rglru": rglru.init_rglru,
}

_MIXER_APPLY = {
    "attn": apply_attention,
    "local_attn": apply_attention,
    "encoder_attn": apply_attention,
    "mla": apply_mla,
    "rwkv6": rwkv6.apply_timemix,
    "rglru": rglru.apply_rglru,
}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_segment(cfg: ModelConfig, seg: Segment, gen, device) -> dict:
    mk = Init(gen, device, dtype_of(cfg), lead=(seg.repeat,))
    p = {
        "norm1": init_norm(cfg, mk),
        "mixer": _MIXER_INIT[seg.mixer](cfg, seg, mk),
        "norm2": init_norm(cfg, mk),
        "ffn": init_ffn(cfg, seg, mk),
    }
    if seg.cross_attn:
        p["norm_x"] = init_norm(cfg, mk)
        p["cross"] = init_cross_attention(cfg, mk)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device="cuda") -> dict:
    """Random parameters with the JAX package's scales: weights
    normal/sqrt(fan_in) unless the JAX init says otherwise, embedding
    normal * 0.02, norm scales one, biases zero.

    Draws from ``generator`` (a ``torch.Generator`` on ``device``), or from a
    new one seeded with ``seed``.  The numbers differ from ``jax.random``'s;
    parity tests convert the JAX parameters instead (``models.convert``).
    ``device="meta"`` gives the tree's shapes and dtypes and draws nothing
    (a resume restores the values: ``distributed.elastic``).
    """
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(seed)
    mk = Init(generator, dev, dtype_of(cfg))
    params: dict = {
        "embed": mk.normal((cfg.vocab_size, cfg.d_model), scale=0.02),
        "final_norm": init_norm(cfg, mk),
        "segments": [_init_segment(cfg, seg, generator, dev) for seg in cfg.segments],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = mk.normal((cfg.d_model, cfg.vocab_size))
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "segments": [_init_segment(cfg, seg, generator, dev) for seg in cfg.encoder_segments],
            "final_norm": init_norm(cfg, mk),
        }
    return params


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _layer(tree, i: int):
    """Layer i's slice of a stacked (leading layer axis) tree: views, no copy."""
    if isinstance(tree, dict):
        return {key: _layer(val, i) for key, val in tree.items()}
    return tree[i]


def _traversal(tree):
    """A layer's DTensor weights gathered over the FSDP axes (the data-
    parallel pool) and kept sharded over the tensor-parallel one, as the
    JAX package's schema gathers weights per traversal: every product of
    the layer is then local, or a partial sum over ``model``.  The gather's
    backward is the gradients' reduce-scatter.  Plain tensors pass through."""
    if isinstance(tree, dict):
        return {key: _traversal(val) for key, val in tree.items()}
    if not isinstance(tree, DTensor):
        return tree
    pool = ("pod", "data", "model") if act_sharding.layout() == "dp_only" else ("pod", "data")
    pl = [Replicate() if (name in pool and p.is_shard()) else p
          for name, p in zip(tree.device_mesh.mesh_dim_names, tree.placements)]
    return tree if tuple(pl) == tuple(tree.placements) else tree.redistribute(tree.device_mesh, pl)


def _unbind(tree, n: int) -> list:
    """A stacked tree -> its n per-layer trees, each leaf a view; the
    gradients of the n views are stacked into the leaf's in one step."""
    if isinstance(tree, dict):
        per_key = {key: _unbind(val, n) for key, val in tree.items()}
        return [{key: per_key[key][i] for key in tree} for i in range(n)]
    return tree.unbind(0)


def _stack(trees: list):
    """Per-layer trees -> one tree stacked on a new leading layer axis."""
    if isinstance(trees[0], dict):
        return {key: _stack([t[key] for t in trees]) for key in trees[0]}
    return torch.stack(trees)


def _write_back(stacked, i: int, new) -> None:
    """Store layer i's new state into the stacked slab.  A leaf the layer
    updated in place (a K/V cache) is already there; a new tensor (a
    recurrent state) is copied in."""
    if isinstance(stacked, dict):
        for key, val in stacked.items():
            _write_back(val, i, new[key])
        return
    dst = stacked[i]
    if _storage(new) != _storage(dst):
        dst.copy_(new)


def _storage(t) -> tuple:
    t = t.to_local() if isinstance(t, DTensor) else t
    return t.untyped_storage()._cdata, t.storage_offset()


def _apply_block(cfg, seg, p, x, *, mode, positions, state, cache_len, enc_out, max_len,
                 pending=None, lengths=None):
    """One block of x.  Returns (x, the FFN output still to add, the new
    state).  The serving modes on plain tensors leave the FFN's residual
    add to the norm after it (the next block's ``norm1``, or the final
    norm), which takes it as its delta: one fused launch for the add and
    the norm.  There ``pending`` is the previous block's FFN output.  The
    other modes add it here and return None.  ``lengths``: decode's
    attention lengths by window (``_decode_lengths``)."""
    st_in = state or {}
    if pending is None:
        h = apply_norm(cfg, p["norm1"], x, mode=mode)
    else:
        x, h = apply_norm(cfg, p["norm1"], x, mode=mode, delta=pending)
    mix_out, mix_st = _MIXER_APPLY[seg.mixer](
        cfg, seg, p["mixer"], h, mode=mode, positions=positions, state=st_in.get("mixer"),
        cache_len=cache_len, max_len=max_len,
        eff_len=None if lengths is None else lengths.get(attention_window(cfg, seg)))
    new_state: dict = {}
    if mix_st is not None:
        new_state["mixer"] = mix_st
    # each residual add is fused into the norm after it: (x + out, norm)
    if seg.cross_attn:
        x, h = apply_norm(cfg, p["norm_x"], x, mode=mode, delta=mix_out)
        enc_kv = st_in["enc_kv"] if mode == "decode" else encode_cross_kv(cfg, p["cross"], enc_out)
        mix_out = apply_cross_attention(cfg, p["cross"], h, enc_kv)
        if mode not in STATELESS:
            new_state["enc_kv"] = enc_kv  # decode carries it through unchanged
    x, h = apply_norm(cfg, p["norm2"], x, mode=mode, delta=mix_out)
    ffn_out, ffn_st = apply_ffn(cfg, seg, p["ffn"], h, state=st_in.get("ffn"), mode=mode)
    if ffn_st is not None and mode not in STATELESS:
        new_state["ffn"] = ffn_st
    if _fused(mode, x):
        return x, ffn_out, new_state
    return x + ffn_out, None, new_state


def _run_segment(cfg, seg, sp, x, *, mode, positions, stacked_state=None, cache_len=None,
                 enc_out=None, max_len=0, pending=None, lengths=None):
    """A segment's layers in order.  Returns (x, the last FFN output still
    to add or None, stacked state or None): prefill stacks every layer's
    state; decode writes it into ``stacked_state``; train keeps none and,
    with ``cfg.remat``, runs each layer under a checkpoint (its activations
    recomputed in backward).  ``pending``: the FFN output the previous
    segment left to add."""
    if mode == "train":
        def body(lp, h):
            return _apply_block(cfg, seg, _traversal(lp), h, mode=mode, positions=positions,
                                state=None,
                                cache_len=None, enc_out=enc_out, max_len=max_len)[0]

        for lp in _unbind(sp, seg.repeat):
            x = checkpoint(body, lp, x, use_reentrant=False) if cfg.remat else body(lp, x)
        return x, None, None
    states = []
    for i in range(seg.repeat):
        st = None if stacked_state is None else _layer(stacked_state, i)
        lp = _traversal(_layer(sp, i))
        x, pending, new = _apply_block(cfg, seg, lp, x, mode=mode, positions=positions, state=st,
                                       cache_len=cache_len, enc_out=enc_out, max_len=max_len,
                                       pending=pending, lengths=lengths)
        if mode == "decode":
            _write_back(stacked_state, i, new)
        states.append(new)
    if mode == "prefill":
        return x, pending, _stack(states)
    return x, pending, stacked_state


def _final_norm(cfg, p, x, pending, mode):
    """The final norm of x, adding the last block's FFN output first."""
    if pending is None:
        return apply_norm(cfg, p, x, mode=mode)
    return apply_norm(cfg, p, x, mode=mode, delta=pending)[1]


def _decode_lengths(cfg, cache_len) -> dict:
    """Each attention window's int32 attention length of a decode step
    (cache_len + 1, clamped to a ring's window), once a step for every
    layer: {window (0: the whole cache): lengths (B,)}."""
    windows = {attention_window(cfg, seg)
               for seg in cfg.segments if seg.mixer in ("attn", "local_attn", "mla")}
    return {w: (torch.clamp(cache_len + 1, max=w) if w else cache_len + 1).to(torch.int32)
            for w in sorted(windows)}


# ---------------------------------------------------------------------------
# Embedding / head / encoder
# ---------------------------------------------------------------------------


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums repeated tokens' rows by
    # sorting, where the indexing backward accumulates with atomics on CUDA
    w = params["embed"]
    if isinstance(w, DTensor):
        x = _vocab_parallel(w, tokens).to(dtype_of(cfg))
    else:
        x = F.embedding(tokens.long(), w).to(dtype_of(cfg))
    if cfg.embed_scale:
        # the scale rounded to x's dtype, as in JAX; torch.full fills on the
        # device (torch.tensor would copy from the host, which a CUDA graph
        # cannot capture)
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return act_sharding.constrain(x, "dp", None, None)


def _vocab_parallel(w: DTensor, tokens) -> DTensor:
    """The vocab-parallel lookup: the embedding (V, d) kept sharded over its
    vocab only (its d gathered), the tokens with their batch over the data-
    parallel axes; each rank looks up the tokens in its own rows (zeros for
    the others), and the result is a partial sum over the vocab's mesh
    dims, which the caller's constraint reduces.  Each rank's gradient of
    its rows is its tokens' share: a partial sum over the data axes."""
    from repro_torch.distributed.sharding import place

    mesh = w.device_mesh
    vocab_dims = [i for i, p in enumerate(w.placements) if p.is_shard() and p.dim == 0]
    w_pl = [p if i in vocab_dims else Replicate() for i, p in enumerate(w.placements)]
    spec = act_sharding.resolve(mesh, tokens.shape, ("dp",) + (None,) * (tokens.dim() - 1))
    tok = place(mesh, tokens, spec)
    grad_pl = [w_pl[i] if i in vocab_dims else
               (Partial() if tok.placements[i].is_shard() else Replicate())
               for i in range(mesh.ndim)]
    wl = w.redistribute(mesh, w_pl).to_local(grad_placements=grad_pl)
    coord, block = mesh.get_coordinate(), 0
    for i in vocab_dims:
        block = block * mesh.size(i) + coord[i]
    idx = tok.to_local().long() - block * wl.shape[0]
    mine = (idx >= 0) & (idx < wl.shape[0])
    x = F.embedding(idx.clamp(0, wl.shape[0] - 1), wl) * mine[..., None].to(wl.dtype)
    out_pl = [Partial() if i in vocab_dims else tok.placements[i] for i in range(mesh.ndim)]
    return DTensor.from_local(x, mesh, out_pl)


def _head_weights(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return _traversal(params["embed"]).T.to(dtype_of(cfg))
    return _traversal(params["lm_head"])


def _encoder_forward(cfg: ModelConfig, params: dict, enc_embeds: torch.Tensor,
                     mode: str = "forward") -> torch.Tensor:
    """Stub-frontend encoder: enc_embeds (B, Se, d) precomputed frames."""
    if enc_embeds is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder model: pass enc_embeds (B, Se, d)")
    x = enc_embeds.to(dtype_of(cfg))
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x = x + sinusoidal_embedding(pos, cfg.d_model).to(x.dtype)
    pending = None
    for seg, sp in zip(cfg.encoder_segments, params["encoder"]["segments"]):
        x, pending, _ = _run_segment(cfg, seg, sp, x, mode=mode, positions=pos, pending=pending)
    return _final_norm(cfg, params["encoder"]["final_norm"], x, pending, "forward")


def _forward(cfg, params, tokens, *, mode, prefix_embeds=None, enc_embeds=None, max_len=0):
    """Shared forward/train/prefill trunk.  Returns (h, states, n_prefix)."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    n_prefix = 0
    if cfg.n_prefix_embeds and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        n_prefix = prefix_embeds.shape[1]
    St = x.shape[1]
    positions = torch.arange(St, device=x.device)[None, :].expand(B, St)
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    enc_mode = "train" if mode == "train" else "forward"
    enc_out = (_encoder_forward(cfg, params, enc_embeds, enc_mode) if cfg.is_encoder_decoder
               else None)
    states, pending = [], None
    for seg, sp in zip(cfg.segments, params["segments"]):
        x, pending, st = _run_segment(cfg, seg, sp, x, mode=mode, positions=positions,
                                      enc_out=enc_out, max_len=max_len, pending=pending)
        states.append(st)
    return _final_norm(cfg, params["final_norm"], x, pending, mode), states, n_prefix


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def _xent_chunk(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor):
    """(sum of the masked token NLLs, count of unmasked labels), both f32."""
    logits = _whole_last((h @ w_head).float())
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - tgt) * mask).sum(), mask.sum()


def _whole_last(x):
    """A DTensor with its last dim (the vocab) gathered on every rank, so
    that picking each label's logit is local."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    pl = [Replicate() if (p.is_partial() or (p.is_shard() and p.dim == last)) else p
          for p in x.placements]
    return x if tuple(pl) == tuple(x.placements) else x.redistribute(x.device_mesh, pl)


def argmax_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy tokens (int32) of logits (..., V); a vocab-sharded DTensor is
    gathered first, so the argmax is each rank's own."""
    return torch.argmax(_whole_last(logits), -1).to(torch.int32)


def _chunked_xent(cfg: ModelConfig, h: torch.Tensor, w_head: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the labels >= 0, in ``cfg.loss_chunk``
    sequence chunks, each recomputed in backward: one chunk's (B, ck, V)
    logits at a time."""
    ck = min(cfg.loss_chunk, h.shape[1])
    tot = cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, h.shape[1], ck):
        t, c = checkpoint(_xent_chunk, h[:, c0:c0 + ck], w_head, labels[:, c0:c0 + ck],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(params: dict, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """batch: tokens (B, S) int, labels (B, S) int (-1 = masked), optional
    prefix_embeds (B, P, d) [VLM: the first P positions carry no loss] and
    enc_embeds (B, Se, d) [enc-dec].  Returns the scalar f32 mean NLL."""
    h, _, n_prefix = _forward(cfg, params, batch["tokens"], mode="train",
                              prefix_embeds=batch.get("prefix_embeds"),
                              enc_embeds=batch.get("enc_embeds"))
    return _chunked_xent(cfg, h[:, n_prefix:], _head_weights(cfg, params), batch["labels"])


# ---------------------------------------------------------------------------
# Serving: forward, prefill + decode
# ---------------------------------------------------------------------------


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, prefix_embeds=None,
            enc_embeds=None) -> torch.Tensor:
    """tokens (B, S) -> f32 logits (B, S, V) at every text position (no
    state): the reference that prefill + decode must reproduce."""
    h, _, n_prefix = _forward(cfg, params, tokens, mode="forward", prefix_embeds=prefix_embeds,
                              enc_embeds=enc_embeds)
    return (h[:, n_prefix:] @ _head_weights(cfg, params)).float()


def prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
            prefix_embeds=None, enc_embeds=None):
    """tokens (B, S) -> (last-token logits (B, V) f32, DecodeState) with
    ``cache_len = S + n_prefix``."""
    B, S = tokens.shape
    h, states, n_prefix = _forward(cfg, params, tokens, mode="prefill",
                                   prefix_embeds=prefix_embeds, enc_embeds=enc_embeds,
                                   max_len=max_len)
    logits = (h[:, -1, :] @ _head_weights(cfg, params)).float()
    state = {
        "cache_len": torch.full((B,), S + n_prefix, dtype=torch.int32, device=h.device),
        "segments": states,
    }
    mesh = act_sharding.current_mesh()
    if mesh is not None:  # the cache laid out by the decode-state rules
        from repro_torch.distributed.sharding import decode_state_shardings

        state = decode_state_shardings(cfg, mesh, B, state, act_sharding.layout())
    return logits, state


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor, state: dict):
    """tokens (B,) new token per sequence -> (logits (B, V) f32, DecodeState).

    ``state`` is updated in place; the returned state holds the same tensors
    and ``cache_len + 1``.
    """
    cache_len = state["cache_len"]
    x = _embed(cfg, params, tokens[:, None])
    positions = cache_len[:, None]
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_embedding(positions, cfg.d_model).to(x.dtype)
    lengths, pending = _decode_lengths(cfg, cache_len), None
    for seg, sp, st in zip(cfg.segments, params["segments"], state["segments"]):
        x, pending, _ = _run_segment(cfg, seg, sp, x, mode="decode", positions=positions,
                                     stacked_state=st, cache_len=cache_len, pending=pending,
                                     lengths=lengths)
    h = _final_norm(cfg, params["final_norm"], x, pending, "decode")
    logits = (h[:, 0, :] @ _head_weights(cfg, params)).float()
    return logits, {"cache_len": cache_len + 1, "segments": state["segments"]}


def greedy(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *, max_len: int,
           steps: int, prefix_embeds=None, enc_embeds=None) -> torch.Tensor:
    """Greedy decoding: prefill ``tokens`` (B, S), then ``steps`` decode
    steps, each feeding back the argmax.  Returns the (B, steps) int32
    tokens (whole on every rank under a mesh)."""
    logits, state = prefill(params, cfg, tokens, max_len=max_len, prefix_embeds=prefix_embeds,
                            enc_embeds=enc_embeds)
    out = []
    for _ in range(steps):
        nxt = argmax_tokens(logits)
        nxt = nxt.full_tensor() if isinstance(nxt, DTensor) else nxt
        out.append(nxt)
        logits, state = decode_step(params, cfg, nxt, state)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Decode-state construction without running prefill (serving slabs)
# ---------------------------------------------------------------------------


def _layer_state_skeleton(cfg: ModelConfig, seg: Segment, batch: int, max_len: int, device):
    st: dict = {}
    if seg.mixer in ("attn", "local_attn"):
        st["mixer"] = attention_init_state(cfg, seg, batch, max_len, device=device)
    elif seg.mixer == "mla":
        st["mixer"] = mla_init_state(cfg, batch, max_len, device=device)
    elif seg.mixer == "rwkv6":
        st["mixer"] = rwkv6.timemix_init_state(cfg, batch, device=device)
    elif seg.mixer == "rglru":
        st["mixer"] = rglru.rglru_init_state(cfg, batch, device=device)
    if seg.cross_attn:
        shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.d_head)
        st["enc_kv"] = {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
                        "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}
    fst = ffn_init_state(cfg, seg, batch, device=device)
    if fst is not None:
        st["ffn"] = fst
    return st


def _zeros_stacked(tree, n: int, dev):
    if isinstance(tree, dict):
        return {key: _zeros_stacked(val, n, dev) for key, val in tree.items()}
    return torch.zeros((n,) + tuple(tree.shape), dtype=tree.dtype, device=dev)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, filled: int = 0,
                      *, device="cuda") -> dict:
    """Zero decode state with capacity ``max_len`` and ``filled`` tokens
    (``device="meta"``: shapes and dtypes only)."""
    dev = torch.device(device)
    if dev.type != "meta":
        dev = resolve_device(dev)
    # one layer's skeleton on the meta device gives the shapes, allocating nothing
    segs = [_zeros_stacked(_layer_state_skeleton(cfg, seg, batch, max_len, "meta"), seg.repeat,
                           dev) for seg in cfg.segments]
    return {
        "cache_len": torch.full((batch,), filled, dtype=torch.int32, device=dev),
        "segments": segs,
    }
