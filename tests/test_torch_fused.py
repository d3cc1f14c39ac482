"""The model body's fused kernels: ``kernels.norm`` (RMSNorm / LayerNorm,
with the residual add before a block's second norm), ``kernels.qk_rope``
(qk-norm + RoPE of q and k, and decode's K/V cache write) and
``kernels.glu`` (the gated activation of SwiGLU / GeGLU).

On the CPU: each plain version against the JAX function it stands for, on
the same numpy inputs (the JAX package imported only where installed, so
that the card's tests run without it); the routing (CPU tensors reach the plain versions in
the serving modes; train mode, the forward reference and a DTensor run
never call the ops); the build's sources and flags; greedy streams equal
to JAX's through the ops.  The tests marked ``cuda`` hold each kernel
against its plain version on the card and the captured engine against
itself under the private plain-on-card switch (``python -m pytest -m cuda
tests/test_torch_fused.py``).

Tolerances against JAX, on the CPU.  float32, where the point is the
algorithm: rtol 1e-6, with atol 2e-6 for outputs that cancel (a rotation,
a LayerNorm near its row's mean), whose error is a few f32 ulps of the O(1)
inputs.  bfloat16: the two frameworks round the bf16 chains at other places
(JAX rounds silu's sigmoid and gelu's inner terms to bf16, ATen computes
them in f32, and their CPU cos / sin may differ in the last f32 bit), so
bf16 is held to 4 bf16 steps (rtol 2^-6) plus one step of the largest
output (atol 2^-8 max|out|) for cancelling outputs; the norms' plain
versions are held to 1 step (2 for LayerNorm, whose centring cancels).
On the card the kernels are held to their plain versions bit for bit
(RoPE, the cache writes, the activations, the residual sums) or within 1
ulp (the norms; a LayerNorm output that cancels within 2^-16 absolute).
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, _plain, wrappers
from repro_torch.kernels.glu import glu, glu_ref
from repro_torch.kernels.norm import norm, norm_ref
from repro_torch.kernels.qk_rope import apply_rope_ref, qk_rope, qk_rope_ref, rope_frequencies
from repro_torch.kernels.qk_rope import ops as qk_ops
from repro_torch.models import lm
from repro_torch.serving.engine import GenerationEngine
from repro_torch.training.tree import leaves

try:  # the parity tests need the JAX package; the card's tests (-m cuda) do not
    import jax
    import jax.numpy as jnp
except ImportError:
    jax = jnp = None

needs_jax = pytest.mark.skipif(jax is None, reason="the parity tests hold the port against the "
                               "JAX package, which is not installed")

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=1e-6, atol=2e-6)
BF16_STEP = 2.0**-8
FUSED = ("norm", "qk_rope", "glu")


def _t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(getattr(torch, dtype))


def _j(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(jnp.dtype(dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _bf16_steps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many bf16 values apart a and b (f32 arrays of bf16 values) lie."""
    def ordered(x):
        i = (x.astype(np.float32).view(np.int32) >> 16).astype(np.int64)
        return np.where(i < 0, -32768 - i, i)
    return np.abs(ordered(a) - ordered(b))


def _close(got, want, dtype, steps=None):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    elif steps is not None:
        assert _bf16_steps(got, want).max() <= steps
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-6,
                                   atol=BF16_STEP * float(np.abs(want).max()))


def _plain_calls():
    return {name: fn.plain_calls for name, fn in wrappers().items() if name in FUSED}


def _launches():
    return {name: fn.launches for name, fn in wrappers().items()}


# ---------------------------------------------------------------------------
# the plain versions against the JAX functions they stand for
# ---------------------------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_matches_jax(dtype, kind, residual):
    from repro.configs import get_config as jax_get_config
    from repro.models import layers as jl

    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(), norm_type=kind,
                              norm_eps=1e-5)
    x, delta = rng.standard_normal((2, 3, 5, 256)), rng.standard_normal((2, 3, 5, 256))
    scale, bias = 1 + 0.1 * rng.standard_normal(256), 0.1 * rng.standard_normal(256)
    jp = {"scale": _j(scale, dtype)}
    if kind == "layernorm":
        jp["bias"] = _j(bias, dtype)
    jx = _j(x, dtype) + _j(delta, dtype) if residual else _j(x, dtype)
    want = jl.apply_norm(cfg, jp, jx)
    n0 = norm.plain_calls
    out = norm(_t(x, dtype), _t(scale, dtype), _t(bias, dtype) if kind == "layernorm" else None,
               kind=kind, eps=cfg.norm_eps, delta=_t(delta, dtype) if residual else None)
    assert norm.plain_calls == n0 + 1
    if residual:
        s, out = out
        assert np.array_equal(_np(s), _np(jx))  # one add, rounded once, on both sides
    assert out.dtype == getattr(torch, dtype)
    _close(out, want, dtype, steps=None if dtype == "float32" else 1 + (kind == "layernorm"))


@needs_jax
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_rope_matches_jax(dtype, qk_norm):
    """Positions 0..4095 (angles up to 4095 rad at the lowest frequency)."""
    from repro.models import layers as jl

    rng = np.random.default_rng(1)
    S, H, KV, dh, theta = 4096, 4, 2, 64, 1e6
    q, k = rng.standard_normal((1, S, H, dh)), rng.standard_normal((1, S, KV, dh))
    qs, ks = 1 + 0.1 * rng.standard_normal(dh), 1 + 0.1 * rng.standard_normal(dh)
    pos = np.arange(S)[None]
    jq, jk = _j(q, dtype), _j(k, dtype)
    if qk_norm:
        jq, jk = jl.rms_norm_headwise(jq, _j(qs, dtype)), jl.rms_norm_headwise(jk, _j(ks, dtype))
    jq = jl.apply_rope(jq, jnp.asarray(pos, jnp.int32), theta)
    jk = jl.apply_rope(jk, jnp.asarray(pos, jnp.int32), theta)
    n0 = qk_rope.plain_calls
    tq, tk = qk_rope(_t(q, dtype), _t(k, dtype), torch.from_numpy(pos), theta=theta,
                     q_scale=_t(qs, dtype) if qk_norm else None,
                     k_scale=_t(ks, dtype) if qk_norm else None)
    assert qk_rope.plain_calls == n0 + 1
    _close(tq, jq, dtype)
    _close(tk, jk, dtype)


@needs_jax
@pytest.mark.parametrize("kind", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_matches_jax(dtype, kind):
    rng = np.random.default_rng(2)
    a, b = 3 * rng.standard_normal((3, 7, 96)), rng.standard_normal((3, 7, 96))
    act = jax.nn.silu if kind == "silu" else jax.nn.gelu  # gelu: the tanh form, as the port
    want = act(_j(a, dtype)) * _j(b, dtype)
    n0 = glu.plain_calls
    out = glu(_t(a, dtype), _t(b, dtype), kind=kind)
    assert glu.plain_calls == n0 + 1
    _close(out, want, dtype)


@needs_jax
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_write_matches_jax_scatter(dtype):
    """The decode write of k (after the qk-norm and RoPE) and v at each
    slot's row, a slot past the end clamped to the last row and a ring slot
    (cache_len % window), against the JAX ``_scatter_time``: equal."""
    from repro.models import layers as jl

    rng = np.random.default_rng(3)
    B, rows, KV, H, dh = 4, 16, 2, 4, 32
    cache_len = np.array([0, 5, 40, 15], np.int32)  # 40: past the end
    for window in (0, 8):
        slot = cache_len % window if window else cache_len
        kc, vc = rng.standard_normal((2, B, rows, KV, dh))
        q, k, v = (rng.standard_normal((B, 1, n, dh)) for n in (H, KV, KV))
        qs, ks = 1 + 0.1 * rng.standard_normal((2, dh))
        tkc, tvc = _t(kc, dtype), _t(vc, dtype)
        _, tk = qk_rope(_t(q, dtype), _t(k, dtype), torch.from_numpy(cache_len[:, None]),
                        theta=1e4, q_scale=_t(qs, dtype), k_scale=_t(ks, dtype),
                        v=_t(v, dtype), k_cache=tkc, v_cache=tvc, slot=torch.from_numpy(slot))
        want_k = jl._scatter_time(_j(kc, dtype), jnp.asarray(_np(tk)).astype(jnp.dtype(dtype)),
                                  jnp.asarray(slot))
        want_v = jl._scatter_time(_j(vc, dtype), _j(v, dtype), jnp.asarray(slot))
        assert np.array_equal(_np(tkc), _np(want_k))
        assert np.array_equal(_np(tvc), _np(want_v))
        assert np.array_equal(_np(tkc[2, rows - 1 if not window else 0]), _np(tk[2, 0]))


def test_frequency_table_is_built_once_by_the_plain_function():
    a = qk_ops.frequency_table(48, 5e5, torch.device("cpu"))
    assert qk_ops.frequency_table(48, 5e5, torch.device("cpu")) is a
    assert torch.equal(a, rope_frequencies(48, 5e5))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b", "recurrentgemma-2b"])
def test_serving_modes_on_cpu_take_the_plain_versions(arch):
    """Prefill and decode on CPU tensors call each op's wrapper, which takes
    its plain version (and launches nothing): per layer two norms (the
    second with the residual add) and one gated activation, plus the final
    norm; per attention layer one qk_rope; MLA's two latent norms."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(1, cfg.vocab_size, size=(2, 9)))
    l0, p0 = _launches(), _plain_calls()
    _, state = lm.prefill(params, cfg, toks, max_len=16)
    p1 = _plain_calls()
    lm.decode_step(params, cfg, toks[:, 0].to(torch.int32), state)
    p2 = _plain_calls()
    assert _launches() == l0
    attn = sum(s.repeat for s in cfg.segments if s.mixer in ("attn", "local_attn"))
    mla = sum(s.repeat for s in cfg.segments if s.mixer == "mla")
    glus = sum(s.repeat for s in cfg.segments if s.ffn in ("swiglu", "geglu"))
    moe = sum(s.repeat for s in cfg.segments if s.ffn == "moe")
    want = {"norm": 2 * cfg.n_layers + 1 + mla * (1 + bool(cfg.q_lora_rank)), "qk_rope": attn,
            "glu": glus + moe * (1 + bool(cfg.n_shared_experts))}
    for step, (a, b) in (("prefill", (p0, p1)), ("decode", (p1, p2))):
        assert {n: b[n] - a[n] for n in FUSED} == want, step


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_train_and_forward_never_call_the_ops(arch):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(1, cfg.vocab_size, size=(2, 9)))
    p0 = _plain_calls()
    lm.forward(params, cfg, toks)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    loss = lm.train_loss(params, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    assert _plain_calls() == p0


_DTENSOR_RUN = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.kernels import wrappers
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import lm

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + sys.argv[1], rank=0, world_size=1)
mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
fused = [wrappers()[n] for n in ("norm", "qk_rope", "glu")]
for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b"):
    cfg = get_config(arch).reduced()
    if arch != "qwen3-1.7b":  # its dense MLA layer: MoE's groups need a mesh of two ranks
        cfg = cfg.reduced(segments=cfg.segments[:1], n_layers=1)
    params = sh.param_shardings(cfg, mesh, lm.init_params(cfg, seed=0, device="cpu"))
    toks = torch.from_numpy(np.random.default_rng(6).integers(1, cfg.vocab_size, size=(2, 9)))
    with use_mesh(mesh):
        if arch == "qwen3-1.7b":  # prefill and greedy decode steps
            assert lm.greedy(params, cfg, toks, max_len=16, steps=3).shape == (2, 3)
        else:  # MLA's latent norm (prefill)
            assert lm.prefill(params, cfg, toks, max_len=16)[0].shape == (2, cfg.vocab_size)
print("calls", [f.plain_calls + f.launches for f in fused], decode_attention.plain_calls)
dist.destroy_process_group()
"""


def test_dtensor_run_never_calls_the_ops(tmp_path):
    """Greedy decoding of reduced qwen3 and a prefill of reduced deepseek's
    dense MLA layer on DTensor parameters (a one-rank gloo mesh): the mesh
    paths run the plain chains, so none of the three ops is called, while
    decode attention runs on each rank's block.  (MoE's groups on the mesh
    run in ``tests/test_torch_sharding.py``, on four ranks.)"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", _DTENSOR_RUN, str(tmp_path / "store")], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    line = next(ln for ln in p.stdout.splitlines() if ln.startswith("calls"))
    assert line.startswith("calls [0, 0, 0]") and int(line.split()[-1]) > 0, line


def test_build_names_six_sources_without_fast_math():
    assert _build.KERNELS == ("ivf_scan", "decode_attention", "topk_merge", "norm", "qk_rope",
                              "glu")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    flags = " ".join(_build.NVCC_FLAGS)
    for fast in ("fast_math", "fast-math", "ftz=true", "prec-div=false", "prec-sqrt=false",
                 "fmad=false"):
        assert fast not in flags
    assert "sm_90a" in flags
    # the sources name no fast intrinsic of the functions they promise exact
    for name in FUSED:
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fast in ("__expf", "__cosf", "__sinf", "__tanhf", "__fdividef", "__powf"):
            assert fast not in src, (name, fast)
    assert set(wrappers()) == set(_build.KERNELS)


def test_no_module_outside_kernels_enters_plain_on_card():
    pkg = ROOT / "src" / "repro_torch"
    enters = re.compile(r"plain_on_card|\b_plain\b")
    users = [str(p.relative_to(pkg)) for p in pkg.rglob("*.py")
             if p.relative_to(pkg).parts[0] != "kernels" and enters.search(p.read_text())]
    assert users == []
    assert enters.search((ROOT / "chip_smoke.py").read_text())  # the pattern finds a user
    assert not _plain.active()
    with _plain.plain_on_card():
        with _plain.plain_on_card():
            assert _plain.active()
        assert _plain.active()
    assert not _plain.active()


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="even dh"):
        qk_rope(torch.zeros(1, 1, 2, 5), torch.zeros(1, 1, 1, 5), torch.zeros(1, 1, dtype=torch.long),
                theta=1e4)
    with pytest.raises(ValueError, match="bias"):
        norm(torch.zeros(2, 8), torch.ones(8), kind="layernorm", eps=1e-5)
    with pytest.raises(ValueError, match="must match"):
        glu(torch.zeros(2, 8), torch.zeros(2, 9))
    with pytest.raises(ValueError, match="cpu or cuda"):
        glu(torch.zeros(2, 8, device="meta"), torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="together"):
        qk_rope(torch.zeros(1, 1, 2, 4), torch.zeros(1, 1, 1, 4), k_cache=torch.zeros(1, 3, 1, 4))


@needs_jax
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_greedy_streams_equal_jax_through_the_ops(arch):
    """The engine's greedy streams over reduced configs, through the ops'
    plain versions on the CPU, equal the JAX engine's.  recurrentgemma's
    segments end with an FFN output that the next segment's first norm
    adds; whisper, which the engine refuses (encoder-decoder), decodes
    greedily through ``lm.greedy`` against JAX's prefill and decode steps,
    its encoder and cross-attention included."""
    from repro.configs import get_config as jax_get_config
    from repro.models import lm as jax_lm
    from repro.serving.engine import GenerationEngine as JaxEngine
    from repro_torch.models.convert import params_from_numpy

    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(7)
    used = {"norm"}  # the ops this family calls (MLA's RoPE stays plain)
    if {s.mixer for s in cfg.segments} & {"attn", "local_attn"}:
        used.add("qk_rope")
    if {s.ffn for s in cfg.segments} & {"swiglu", "geglu", "moe"}:
        used.add("glu")
    p0 = _plain_calls()
    if cfg.is_encoder_decoder:
        tokens = rng.integers(1, cfg.vocab_size, size=(2, 9)).astype(np.int32)
        enc = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        got = lm.greedy(params, cfg, torch.from_numpy(tokens), max_len=32, steps=6,
                        enc_embeds=torch.from_numpy(enc)).numpy()
        logits, state = jax_lm.prefill(jparams, jcfg, jnp.asarray(tokens), max_len=32,
                                       enc_embeds=jnp.asarray(enc))
        want = []
        for _ in range(6):
            nxt = jnp.argmax(logits, -1).astype(jnp.int32)
            want.append(np.asarray(nxt))
            logits, state = jax_lm.decode_step(jparams, jcfg, nxt, state)
        assert all(_plain_calls()[n] > p0[n] for n in used)
        assert np.array_equal(got, np.stack(want, 1))
        return
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 17, 33, 9)]
    # recurrentgemma: padded widths that are multiples of its 16-row ring
    # (the JAX package's ring prefill is wrong at other lengths; ROADMAP C)
    kw = dict(max_batch=2, max_len=96 if cfg.local_window else 64, eos_id=-1)
    got = _serve(GenerationEngine(cfg, params, device="cpu", **kw), prompts)
    assert all(_plain_calls()[n] > p0[n] for n in used)
    assert got == _serve(JaxEngine(jcfg, jparams, **kw), prompts)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "whisper-medium"])
def test_serving_forward_equals_forward_bit_for_bit(arch):
    """The prefill trunk (the serving modes: each FFN output handed on to
    the next norm as its delta, across segment ends and into the final
    norm) equals the forward trunk (the adds on their own) bit for bit on
    the CPU, where the norm's plain version adds the delta as the chain
    does."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(2, 11)))
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    h_fwd = lm._forward(cfg, params, toks, mode="forward", **kw)[0]
    h_srv = lm._forward(cfg, params, toks, mode="prefill", max_len=16, **kw)[0]
    assert _bits_equal(h_srv, h_fwd)


@pytest.mark.parametrize("mode", ["forward", "train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-2b"])
def test_only_the_serving_modes_hand_the_ffn_residual_on(arch, mode):
    """A segment run in prefill returns its last FFN output still to add
    (x + it equals the forward run's x bit for bit, on the CPU); train mode
    and the forward reference add it themselves and return none."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    seg, sp = cfg.segments[0], params["segments"][0]
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 7, cfg.d_model))
                         .astype(np.float32)).to(params["embed"].dtype)
    pos = torch.arange(7)[None].expand(2, 7)
    want, none, _ = lm._run_segment(cfg, seg, sp, x, mode="forward", positions=pos)
    assert none is None
    got, pending, _ = lm._run_segment(cfg, seg, sp, x, mode=mode, positions=pos, max_len=8)
    assert (pending is None) == (mode != "prefill")
    assert _bits_equal(got if pending is None else got + pending, want)


def _serve(eng, prompts, max_new=(3, 6, 4, 5)):
    pending = list(zip(prompts, max_new))
    seqs = []
    while pending or eng.seqs:
        while pending and eng.can_admit():
            prompt, n = pending.pop(0)
            seqs.append(eng.seqs[eng.add_sequence(prompt, max_new=n)])
        eng.step()
    return [list(s.tokens) for s in seqs]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bits_equal(a, b) -> bool:
    view = {4: torch.int32, 2: torch.int16}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _within_norm_tol(got, want, layernorm=False) -> bool:
    """The norms' tolerance on the card: f32 rtol 1e-6, atol 1e-6; bf16 1 ulp,
    except a LayerNorm output that is a difference of nearly equal terms
    (x minus the row's mean, a bias cancelling the scaled value), whose one
    ulp is finer than the f32 ulps of those O(1) terms: 2^-16 absolute."""
    if got.dtype == torch.float32:
        return bool(torch.allclose(got, want, rtol=1e-6, atol=1e-6))
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    over = _bf16_steps(g, w) > 1
    return not over.any() or (layernorm and bool((np.abs(g - w)[over] <= 2.0**-16).all()))


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_kernel_against_plain_on_card(cuda, dtype, kind, residual):
    rng = np.random.default_rng(10)
    # the kernel's layouts: lane groups (64, 128, 512), one warp (2048), a
    # few warps a row (2560 and up; 32768 f32 at 16 vectors a lane)
    for rows, d in ((8, 2048), (1024, 2048), (7, 5120), (3, 8192), (1, 64), (13, 128), (5, 512),
                    (4, 2560), (2, 32768)):
        x, delta = (_t(rng.standard_normal((rows, d)), dtype).to(cuda) for _ in range(2))
        scale = _t(1 + 0.1 * rng.standard_normal(d), dtype).to(cuda)
        bias = _t(0.1 * rng.standard_normal(d), dtype).to(cuda) if kind == "layernorm" else None
        args = dict(kind=kind, eps=1e-6, delta=delta if residual else None)
        n0 = norm.launches
        got = norm(x, scale, bias, **args)
        assert norm.launches == n0 + 1
        want = norm_ref(x, scale, bias, **args)
        if residual:
            assert _bits_equal(got[0], want[0])
            got, want = got[1], want[1]
        assert _within_norm_tol(got, want, kind == "layernorm"), (rows, d)
        again = norm(x, scale, bias, **args)
        assert _bits_equal(got, again[1] if residual else again)
    # a strided row (MLA's latent slice of a wider product)
    wide = _t(rng.standard_normal((2, 5, 576)), dtype).to(cuda)
    scale = _t(1 + 0.1 * rng.standard_normal(512), dtype).to(cuda)
    if kind == "rmsnorm" and not residual:
        assert _within_norm_tol(norm(wide[..., :512], scale, eps=1e-6),
                                norm_ref(wide[..., :512], scale, eps=1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_row_across_layouts_on_card(cuda, dtype, kind):
    """The kernel is not batch-invariant: at d 2048 bf16 a launch of 8 rows
    (a decode step) gives a row 256 lanes, one of 504 rows 64 and one of
    512 or 1024 rows 32 (f32: 512 lanes, then 64), so the row's sum runs in
    another order.
    The same rows' y stay within the norms' tolerance of the decode
    launch's (1 bf16 ulp, the LayerNorm cancel bound, rtol 1e-6 in f32),
    and their residual sum is the same bits."""
    rng = np.random.default_rng(12)
    d = 2048
    x, delta = (_t(rng.standard_normal((1024, d)), dtype).to(cuda) for _ in range(2))
    scale = _t(1 + 0.1 * rng.standard_normal(d), dtype).to(cuda)
    bias = _t(0.1 * rng.standard_normal(d), dtype).to(cuda) if kind == "layernorm" else None
    res, y = norm(x[:8], scale, bias, kind=kind, eps=1e-6, delta=delta[:8])
    for rows in (504, 512, 1024):
        got = norm(x[:rows], scale, bias, kind=kind, eps=1e-6, delta=delta[:rows])
        assert _bits_equal(got[0][:8], res)
        assert _within_norm_tol(got[1][:8], y, kind == "layernorm"), rows


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 96, 100, 128, 160, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qk_rope_kernel_against_plain_on_card(cuda, dtype, dh):
    """Every d_head of the zoo, and 100, whose halves are no whole number
    of 16-byte vectors (the kernel's scalar accesses, which heads one
    element off a 16-byte boundary take too: S = 5)."""
    rng = np.random.default_rng(11)
    B, H, KV, rows = 3, 6, 2, 40
    for S in (1, 37, 5):
        def heads(n):
            t = _t(rng.standard_normal(B * S * n * dh + 1), dtype).to(cuda)
            return t[int(S == 5):][:B * S * n * dh].view(B, S, n, dh)

        q, k = heads(H), heads(KV)
        qs, ks = (_t(1 + 0.1 * rng.standard_normal(dh), dtype).to(cuda) for _ in range(2))
        pos = torch.arange(4090, 4090 + S, device=cuda)[None].expand(B, S)  # int64, stride 0
        # RoPE alone: bit for bit
        got = qk_rope(q, k, pos, theta=1e6)
        want = qk_rope_ref(q, k, pos, theta=1e6)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        # the qk-norm alone: within 1 ulp; then norm + RoPE equals RoPE of
        # the kernel's own norm output, bit for bit
        normed = qk_rope(q, k, q_scale=qs, k_scale=ks)
        want = qk_rope_ref(q, k, q_scale=qs, k_scale=ks)
        assert all(_within_norm_tol(a, b) for a, b in zip(normed, want))
        both = qk_rope(q, k, pos, theta=1e6, q_scale=qs, k_scale=ks)
        assert all(_bits_equal(a, apply_rope_ref(n, pos, 1e6)) for a, n in zip(both, normed))
        again = qk_rope(q, k, pos, theta=1e6, q_scale=qs, k_scale=ks)
        assert all(_bits_equal(a, b) for a, b in zip(both, again))
    # decode: the cache write at each slot (0, past the end, a ring slot),
    # int32 positions
    q, k, v = (_t(rng.standard_normal((B, 1, n, dh)), dtype).to(cuda) for n in (H, KV, KV))
    caches = [_t(rng.standard_normal((B, rows, KV, dh)), dtype).to(cuda) for _ in range(2)]
    cache_len = torch.tensor([0, 57, 13], dtype=torch.int32, device=cuda)
    for slot in (cache_len, cache_len % 8):
        (kc, vc), (kr, vr) = ([c.clone() for c in caches] for _ in range(2))
        got = qk_rope(q, k, cache_len[:, None], theta=1e4, q_scale=qs, k_scale=ks, v=v,
                      k_cache=kc, v_cache=vc, slot=slot)
        qk_rope_ref(q, k, cache_len[:, None], theta=1e4, q_scale=qs, k_scale=ks, v=v,
                    k_cache=kr, v_cache=vr, slot=slot)
        assert _bits_equal(vc, vr)
        # the k rows written are the kernel's own k output, at the clamped rows
        row = slot.long().clamp(0, rows - 1)
        assert _bits_equal(kc[torch.arange(B, device=cuda), row], got[1][:, 0])
        untouched = torch.ones(B, rows, dtype=torch.bool, device=cuda)
        untouched[torch.arange(B, device=cuda), row] = False
        assert _bits_equal(kc[untouched], caches[0][untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_glu_kernel_against_plain_on_card(cuda, dtype, kind):
    rng = np.random.default_rng(12)
    for shape in ((8, 1, 6144), (1, 1024, 6144), (3, 5, 8), (64, 9, 1408)):
        a = _t(4 * rng.standard_normal(shape), dtype).to(cuda)
        b = _t(rng.standard_normal(shape), dtype).to(cuda)
        got = glu(a, b, kind=kind)
        assert _bits_equal(got, glu_ref(a, b, kind=kind)), shape
        assert _bits_equal(got, glu(a, b, kind=kind))
    a = _t(np.linspace(-30, 30, 4099), dtype).to(cuda)  # a ragged tail past the vectors
    assert _bits_equal(glu(a, a, kind=kind), glu_ref(a, a, kind=kind))


@pytest.mark.cuda
def test_plain_on_card_switch_takes_the_plain_versions(cuda):
    x = torch.randn(4, 64, device=cuda)
    l0, p0 = norm.launches, norm.plain_calls
    with _plain.plain_on_card():
        norm(x, torch.ones(64, device=cuda), eps=1e-6)
    assert (norm.launches, norm.plain_calls) == (l0, p0 + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b", "paligemma-3b"])
def test_captured_engine_streams_equal_plain_on_card(cuda, arch):
    """The captured engine (decode and prefill graphs) through the kernels
    and the same engine built under the plain-on-card switch (the graphs
    record the plain chains) give the same greedy streams; each replay adds
    the fused kernels' launches."""
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device=cuda)
    prompts = [np.random.default_rng(13).integers(1, cfg.vocab_size, size=n)
               for n in (5, 17, 33, 9)]
    kw = dict(max_batch=2, max_len=64, eos_id=-1)
    eng = GenerationEngine(cfg, params, device=cuda, **kw)
    assert all(eng._graph_launches.get(n, 0) > 0 for n in ("norm", "glu"))
    l0 = _launches()
    got = _serve(eng, prompts)
    assert all(_launches()[n] > l0[n] for n in ("norm", "glu"))
    with _plain.plain_on_card():
        plain = GenerationEngine(cfg, params, device=cuda, **kw)
        want = _serve(plain, prompts)
    assert plain._graph_launches.get("norm", 0) == 0
    assert got == want
