"""The port's generation engine and launcher over every decoder-only
family: greedy streams identical to the JAX ``GenerationEngine`` (as
``test_torch_model.py::test_greedy_streams_identical`` checks qwen3), with
slots reused so that the admission body copies every kind of state, and the
launcher serving each family on the CPU."""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="the parity tests hold the port against the JAX package")
import torch  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jax_lm  # noqa: E402
from repro.serving.engine import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402

DECODER_ONLY = [a for a in ARCH_IDS if not get_config(a).is_encoder_decoder]


def _serve(eng, prompts, max_new):
    pending = list(prompts)
    done, seqs = {}, {}
    while pending or eng.seqs:
        while pending and eng.can_admit():
            sid = eng.add_sequence(pending.pop(0), max_new=max_new)
            seqs[sid] = eng.seqs[sid]
        eng.step()
        for sid, seq in seqs.items():
            if seq.done:
                done[sid] = list(seq.tokens)
    return done


@pytest.mark.parametrize("arch", DECODER_ONLY)
def test_greedy_streams_identical(arch):
    assert len(DECODER_ONLY) == 9
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax_lm.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 33, 9, 40)]
    kw = dict(max_batch=4, max_len=96, eos_id=0)
    teng = GenerationEngine(cfg, params, device="cpu", **kw)
    tout = _serve(teng, prompts, 8)
    jout = _serve(JaxEngine(jcfg, jparams, **kw), prompts, 8)
    assert len(tout) == len(prompts)
    assert sum(map(len, tout.values())) > 2 * len(prompts)  # decode steps ran
    assert tout == jout


def test_engine_refuses_encoder_decoder():
    cfg = get_config("whisper-medium").reduced()
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="encoder-decoder"):
        GenerationEngine(cfg, params, device="cpu")


def test_engine_insert_copies_recurrent_state():
    """A prefilled sequence's RWKV and channel-mix states land in its slot,
    and decode advances them there (the slab, not a copy)."""
    cfg = get_config("rwkv6-1.6b").reduced()
    eng = GenerationEngine(cfg, lm.init_params(cfg, seed=0, device="cpu"), max_batch=2,
                           max_len=64, eos_id=-1, device="cpu")
    eng.add_sequence(np.arange(1, 12), max_new=4)
    slot = next(iter(eng.seqs.values())).slot
    seg = eng.state["segments"][0]
    S0, cmix0 = seg["mixer"]["S"][:, slot].clone(), seg["ffn"][:, slot].clone()
    assert S0.abs().sum() > 0 and cmix0.abs().sum() > 0
    assert seg["mixer"]["S"][:, 1 - slot].abs().sum() == 0
    eng.step()
    assert not torch.equal(seg["mixer"]["S"][:, slot], S0)
    assert not torch.equal(seg["ffn"][:, slot], cmix0)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-2b", "rwkv6-1.6b"])
def test_launcher_serves_arch_on_cpu(arch, capsys):
    m = serve.main(["--device", "cpu", "--arch", arch, "--n-requests", "3", "--max-new", "4",
                    "--workflow", "irg", "--arrival-gap-ms", "1000"])
    assert m.finished == 3
    assert "on cpu" in capsys.readouterr().out


def test_launcher_refuses_whisper(capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--arch", "whisper-medium"])
    assert exc.value.code == 2
    assert "encoder-decoder" in capsys.readouterr().err
