"""The generation engine's decode step as one captured CUDA graph.

The captured step reads and writes only tensors whose addresses never
change (the slab's leaves, ``cache_len``, the last and next tokens, the
active-slot mask).  On the CPU, where the engine runs the same step body
eagerly, every decoder-only family (reduced) is served with slots admitted
and retired mid-stream and no buffer may change its identity or its
``data_ptr``: the capture's precondition.  The tests marked ``cuda`` run on
the card (``python -m pytest -m cuda tests/test_torch_engine_graph.py``):
the captured engine's greedy stream equals the eager step body's for every
family, each replay counts its ``decode_attention`` launches, a seeded
temperature stream repeats, and the warm-up before the capture leaves no
trace.  The JAX package's greedy streams are held in
``tests/test_torch_zoo_engine.py``.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import lm
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.sampler import SamplerConfig

DECODER_ONLY = [a for a in ARCH_IDS if not get_config(a).is_encoder_decoder]
KW = dict(max_batch=2, max_len=96, eos_id=-1)
MAX_NEW = (3, 6, 4, 8, 5)  # unequal, so slots retire and are reused mid-stream


def _prompts(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 17, 33, 9, 21)]


def _serve(eng, prompts, on_event=lambda: None):
    """Admit whenever a slot is free, step until every sequence is done;
    ``on_event`` runs after each admission and each step.  Returns each
    sequence's tokens in admission order."""
    pending = list(zip(prompts, MAX_NEW))
    seqs = []
    while pending or eng.seqs:
        while pending and eng.can_admit():
            prompt, max_new = pending.pop(0)
            seqs.append(eng.seqs[eng.add_sequence(prompt, max_new=max_new)])
            on_event()
        eng.step()
        on_event()
    return [list(s.tokens) for s in seqs]


def _fingerprint(eng):
    return [(id(t), t.data_ptr()) for t in eng._buffers()]


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_buffers_keep_their_addresses(arch):
    assert len(DECODER_ONLY) == 9
    cfg = get_config(arch).reduced()
    eng = GenerationEngine(cfg, lm.init_params(cfg, seed=0, device="cpu"), device="cpu", **KW)
    state, segments, before = eng.state, eng.state["segments"], _fingerprint(eng)
    n_leaves = len(before)
    events = []

    def check():
        assert eng.state is state and eng.state["segments"] is segments
        assert _fingerprint(eng) == before
        events.append(eng.batch_size)

    out = _serve(eng, _prompts(cfg), check)
    assert [len(t) for t in out] == list(MAX_NEW)
    assert 0 in events and max(events) == KW["max_batch"]  # retired, refilled, drained
    assert n_leaves > 5  # cache_len, the state's leaves, tokens, mask


def test_step_body_matches_the_decode_step():
    """One engine step equals ``lm.decode_step`` + argmax on a copy of the
    slab, and advances only the active slots' ``cache_len``."""
    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    eng = GenerationEngine(cfg, params, device="cpu", **KW)
    sid = eng.add_sequence(_prompts(cfg)[1], max_new=8)
    slot = eng.seqs[sid].slot
    copy = {"cache_len": eng.state["cache_len"].clone(),
            "segments": [{k: {kk: vv.clone() for kk, vv in v.items()} for k, v in seg.items()}
                         for seg in eng.state["segments"]]}
    logits, _ = lm.decode_step(params, cfg, eng._last_tokens.clone(), copy)
    cl0 = eng.state["cache_len"].clone()
    tok = eng.step()[sid]
    assert tok == int(torch.argmax(logits[slot]))
    want = cl0.clone()
    want[slot] += 1
    assert torch.equal(eng.state["cache_len"], want)
    assert int(eng._last_tokens[slot]) == tok


def test_seeded_temperature_stream_repeats():
    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    sampler = SamplerConfig(temperature=1.0, top_k=20)

    def run(seed):
        return _serve(GenerationEngine(cfg, params, device="cpu", sampler=sampler, seed=seed,
                                       **KW), _prompts(cfg))

    assert run(7) == run(7)
    assert run(7) != run(8)


def test_dtensor_engine_is_not_captured():
    """Parameters placed on a mesh (DTensors) keep the engine eager on any
    device, its step and its admissions: DTensor's sharding propagation
    runs on the host at each op."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_config("qwen3-1.7b").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    own_group = not dist.is_initialized()
    mesh = make_host_mesh(1, device_type="cpu")
    try:
        dparams = param_shardings(cfg, mesh, params)
        eng = GenerationEngine(cfg, dparams, device="cpu", **KW)
        assert engine_mod._holds_dtensor([dparams, eng.state])
        assert not engine_mod._holds_dtensor([params, eng.state])
        assert eng._graph is None and eng.step() == {}
        assert not eng._capture_prefills and eng._prefills == {}  # no prefill graph either
    finally:
        if own_group:
            dist.destroy_process_group()


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


def _card_engines(arch, dev, **kw):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device=dev)
    return cfg, params, GenerationEngine(cfg, params, device=dev, **{**KW, **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_captured_stream_equals_eager_body(cuda, arch):
    cfg, params, captured = _card_engines(arch, cuda)
    assert captured._graph is not None
    eager = GenerationEngine(cfg, params, device=cuda, **KW)
    eager._graph = None  # the same step body, run op by op
    before = _fingerprint(captured)
    got = _serve(captured, _prompts(cfg))
    assert _fingerprint(captured) == before
    want = _serve(eager, _prompts(cfg))
    assert [len(t) for t in got] == list(MAX_NEW)
    assert got == want


@pytest.mark.cuda
def test_replays_count_decode_attention_launches(cuda):
    cfg, _, eng = _card_engines("qwen3-1.7b", cuda)
    assert eng._graph_launches["decode_attention"] == cfg.n_layers
    replays = []
    n0 = decode_attention.launches

    def count():
        replays.append(bool(eng.seqs))  # a step with no sequence replays nothing
        return orig()

    orig, eng.step = eng.step, count
    _serve(eng, _prompts(cfg))
    assert decode_attention.launches - n0 == cfg.n_layers * sum(replays)


@pytest.mark.cuda
def test_seeded_temperature_stream_repeats_on_card(cuda):
    sampler = SamplerConfig(temperature=1.0, top_k=20)
    cfg, params, a = _card_engines("qwen3-1.7b", cuda, sampler=sampler, seed=7)
    b = GenerationEngine(cfg, params, device=cuda, sampler=sampler, seed=7, **KW)
    c = GenerationEngine(cfg, params, device=cuda, sampler=sampler, seed=8, **KW)
    assert a._graph is not None
    ta, tb, tc = (_serve(e, _prompts(cfg)) for e in (a, b, c))
    assert ta == tb and ta != tc


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-1.6b"])
def test_warm_up_leaves_no_trace(cuda, arch):
    """The warm-up step before the capture wrote a K/V row or advanced a
    recurrent state and drew from the generator: all of it is undone."""
    sampler = SamplerConfig(temperature=1.0)
    cfg, params, eng = _card_engines(arch, cuda, sampler=sampler, seed=3)
    assert all(int(torch.count_nonzero(t)) == 0 for t in eng._buffers())
    fresh = torch.Generator(device=cuda)
    fresh.manual_seed(3)
    assert torch.equal(eng._gen.get_state(), fresh.get_state())
