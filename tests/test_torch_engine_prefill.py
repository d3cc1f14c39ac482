"""The generation engine's admission (prefill + slot insert) as one body
over fixed buffers, captured as a CUDA graph for each padded width.

On the CPU, where the engine runs the body eagerly, every decoder-only
family (reduced) must leave the slab (every leaf), ``cache_len``, the last
tokens and the first token bit-identical to ``lm.prefill`` followed by a
leaf-by-leaf insert (the engine's former ``_insert``) at slots in the middle
of the slab; each width's buffers keep their addresses across admissions;
a width that the cache's decode room clips (504 for a 300-token prompt
with 8 new tokens in a 512-row cache) gets buffers of its own.  The tests
marked ``cuda`` run on the card (``python -m pytest -m cuda
tests/test_torch_engine_prefill.py``): an engine with both graphs (decode
and prefill) gives the greedy streams of one with both dropped, its slab
bit-identical after every admission and step, with widths replayed out of
their capture order between decode replays; each width is captured once,
and the body runs eagerly only at a width's first admission.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import lm
from repro_torch.serving.engine import GenerationEngine, _bucket
from repro_torch.training.tree import leaves, tree_map

DECODER_ONLY = [a for a in ARCH_IDS if not get_config(a).is_encoder_decoder]
KW = dict(max_batch=4, max_len=96, eos_id=-1)


def _engine(arch, dev="cpu", **kw):
    cfg = get_config(arch).reduced()
    params = lm.init_params(cfg, seed=0, device=dev)
    return cfg, params, GenerationEngine(cfg, params, device=dev, **{**KW, **kw})


def _width(n, max_new, max_len):
    """The padded width of an n-token prompt: its bucket, clipped to what
    the cache keeps after the decode room."""
    keep = max(max_len - min(max_new, max(max_len // 2, 1)), 1)
    return min(_bucket(min(n, keep)), keep)


def _reference_admission(params, cfg, state, last_tokens, prompt, slot, max_len, max_new):
    """``lm.prefill`` of the left-padded prompt, then the insert leaf by
    leaf with a Python slot, into copies of ``state`` and ``last_tokens``.
    Returns (state, last tokens, first token)."""
    pad_to = _width(len(prompt), max_new, max_len)
    prompt = np.asarray(prompt)[-pad_to:]
    toks = np.zeros((1, pad_to), np.int64)
    toks[0, pad_to - len(prompt):] = prompt
    logits, one = lm.prefill(params, cfg, torch.from_numpy(toks), max_len=max_len)
    state, last_tokens = tree_map(torch.clone, state), last_tokens.clone()
    state["cache_len"][slot] = one["cache_len"][0]

    def ins(slab, new):
        if isinstance(slab, dict):
            for name in slab:
                ins(slab[name], new[name])
        else:
            slab[:, slot] = new[:, 0]  # (L, B, ...) <- (L, 1, ...)

    for slab_seg, one_seg in zip(state["segments"], one["segments"]):
        ins(slab_seg, one_seg)
    first = int(torch.argmax(logits[0]))
    last_tokens[slot] = first
    return state, last_tokens, first


def _leaves(eng):
    return [eng.state["cache_len"], *leaves(eng.state["segments"]), eng._last_tokens]


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_admission_body_equals_prefill_and_insert(arch):
    """Two admissions into slots 2 and 1 of a 4-slot slab whose slot 3
    holds a sequence that has decoded: the body leaves what prefill + the
    leaf-by-leaf insert leaves, bit for bit, and the other slots as they
    were."""
    assert len(DECODER_ONLY) == 9
    cfg, params, eng = _engine(arch)
    rng = np.random.default_rng(2)
    eng.add_sequence(rng.integers(1, cfg.vocab_size, size=11), max_new=6)  # slot 3
    eng.step()
    eng.free_slots = [0, 1, 2]
    for n, max_new in ((23, 5), (50, 8)):
        prompt = rng.integers(1, cfg.vocab_size, size=n)
        slot = eng.free_slots[-1]
        want_state, want_last, want_first = _reference_admission(
            params, cfg, eng.state, eng._last_tokens, prompt, slot, eng.max_len, max_new)
        sid = eng.add_sequence(prompt, max_new=max_new)
        assert eng.seqs[sid].slot == slot and slot in (1, 2)
        assert eng.seqs[sid].tokens == [want_first]
        want = [want_state["cache_len"], *leaves(want_state["segments"]), want_last]
        got = _leaves(eng)
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)


def test_width_buffers_keep_their_addresses():
    cfg, _, eng = _engine("qwen3-1.7b")
    rng = np.random.default_rng(3)

    def ptrs():
        return {w: [t.data_ptr() for t in (b.tokens, b.slot, b.first, b.tokens_host,
                                           b.slot_host)] for w, b in eng._prefills.items()}

    seen = {}
    for n in (20, 40, 9, 33, 60, 31, 17):  # widths 32, 64, 32, 64, 64, 32, 32
        while not eng.can_admit():
            eng.step()
        eng.add_sequence(rng.integers(1, cfg.vocab_size, size=n), max_new=4)
        now = ptrs()
        for w, p in seen.items():
            assert now[w] == p
        seen.update(now)
    assert sorted(seen) == [32, 64]


def test_clipped_width_gets_its_own_buffers():
    """Widths are the bucket clipped to what the cache keeps after the
    decode room: 300 tokens with 8 new in a 512-row cache pad to 504, with
    100 new to 412; a 200-token prompt pads to its bucket, 256."""
    cfg, _, eng = _engine("qwen3-1.7b", max_len=512)
    rng = np.random.default_rng(4)
    plan = ((300, 8, 504), (300, 100, 412), (200, 8, 256), (290, 8, 504))
    bufs = {}
    for n, max_new, width in plan:
        prompt = rng.integers(1, cfg.vocab_size, size=n)
        sid = eng.add_sequence(prompt, max_new=max_new)
        buf = eng._prefills[width]
        assert bufs.setdefault(width, buf) is buf
        assert buf.tokens.shape == (1, width)
        assert torch.equal(buf.tokens[0, width - n:], torch.as_tensor(prompt, dtype=torch.int64))
        assert int(buf.tokens[0, :width - n].abs().sum()) == 0  # left padding
        assert eng.seqs[sid].max_new == min(max_new, eng.max_len - width)
    assert sorted(eng._prefills) == [256, 412, 504]
    assert all(b.graph is None for b in eng._prefills.values())  # the CPU runs the body


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (prompt length, new tokens): widths 64, 32 and 88 (70 tokens with 8 new in
# a 96-row cache: the bucket 128 clipped) captured in that order, then
# replayed in the reverse order, 2 slots, so decode replays come between
CARD_PLAN = ((40, 3), (20, 6), (70, 8), (75, 8), (15, 5), (35, 4))


def test_card_plan_widths():
    assert [_width(n, m, KW["max_len"]) for n, m in CARD_PLAN] == [64, 32, 88, 88, 32, 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_graphs_give_the_eager_streams(cuda, arch):
    cfg, params, captured = _engine(arch, cuda, max_batch=2)
    eager = GenerationEngine(cfg, params, device=cuda, **{**KW, "max_batch": 2})
    eager._graph, eager._capture_prefills = None, False  # both bodies, op by op
    assert captured._graph is not None and captured._capture_prefills
    captures, bodies = [], []
    capture, body = captured._capture, captured._prefill

    def count_capture(*a, **k):
        captures.append(1)
        return capture(*a, **k)

    def count_body(buf):
        bodies.append(buf.tokens.shape[1])
        return body(buf)

    captured._capture, captured._prefill = count_capture, count_body
    rng = np.random.default_rng(5)
    pending = [(rng.integers(1, cfg.vocab_size, size=n), m) for n, m in CARD_PLAN]
    seqs = ([], [])

    def same():
        for g, w in zip(_leaves(captured), _leaves(eager)):
            assert torch.equal(g, w)

    while pending or captured.seqs:
        while pending and captured.can_admit():
            prompt, max_new = pending.pop(0)
            for eng, out in zip((captured, eager), seqs):
                out.append(eng.seqs[eng.add_sequence(prompt, max_new=max_new)])
            same()
        assert captured.step() == eager.step()
        same()
    assert len(captures) == 3 and sorted(captured._prefills) == [32, 64, 88]
    assert all(b.graph is not None for b in captured._prefills.values())
    # eager only at a width's first admission: the warm-up, then the
    # capture's recording of the body
    assert bodies == [64, 64, 32, 32, 88, 88]
    assert [list(s.tokens) for s in seqs[0]] == [list(s.tokens) for s in seqs[1]]
    assert [len(s.tokens) for s in seqs[0]] == [m for _, m in CARD_PLAN]


@pytest.mark.cuda
def test_prefill_replays_keep_decode_attention_counts(cuda):
    """Prefill attends with plain attention: a width's capture and its
    replays add no ``decode_attention`` launch."""
    from repro_torch.kernels.decode_attention import decode_attention

    cfg, _, eng = _engine("qwen3-1.7b", cuda)
    rng = np.random.default_rng(6)
    n0 = decode_attention.launches
    for n in (40, 45, 50):
        eng.add_sequence(rng.integers(1, cfg.vocab_size, size=n), max_new=4)
    assert decode_attention.launches == n0
    assert eng._prefills[64].graph is not None
