"""The port's checkpoint, elastic runner, train launcher and training
example, on the CPU.

- The checkpoint round trip is bit for bit, bf16 leaves included (stored as
  their uint16 bits under the dtype ``"bfloat16"``); its leaf keys are the
  JAX package's key paths for the same tree; ``keep`` prunes, and a
  leftover ``.tmp`` directory (a save cut short) is not counted.
- ``ElasticRunner`` resumes from the latest step, restoring into a tree
  built on the meta device (no parameters drawn twice).
- The launcher resumes where it stopped: the steps a resumed run takes have
  the losses of the same steps of an uninterrupted run, bit for bit.
  ``--production-mesh`` exits 2.  The example trains and resumes.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.distributed.elastic import ElasticConfig, ElasticRunner
from repro_torch.examples import train_lm
from repro_torch.launch import train
from repro_torch.models import lm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.tree import leaves_with_paths

CFG = get_config("qwen3-1.7b").reduced(dtype="bfloat16")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The launcher and the example train for a few steps: on one intra-op
    thread, so that beside the suite's other workers they do not thrash
    (the example's steps took 112 s on 8 threads in a 6-worker run, 1.4 s
    alone)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(device="cpu", seed=0):
    params = lm.init_params(CFG, seed=seed, device=device)
    opt = init_opt_state(params)
    if device != "meta":
        gen = torch.Generator().manual_seed(seed)
        for _, m in leaves_with_paths(opt["mu"]):
            m.copy_(torch.randn(m.shape, generator=gen))
        opt["step"].fill_(7)
    return {"params": params, "opt": opt}


def _assert_same_bits(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x.view(torch.uint8) if x.dim() else x, y.view(torch.uint8) if y.dim()
                           else y), k


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    state = _state()
    assert state["params"]["embed"].dtype == torch.bfloat16
    ckpt.save_checkpoint(str(tmp_path), 7, state, extra={"note": "x"}, keep=2)
    ckpt.save_checkpoint(str(tmp_path), 14, _state(seed=1), keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 14
    step, restored, extra = ckpt.restore_checkpoint(str(tmp_path), 7, like=_state("meta"),
                                                    device="cpu")
    assert step == 7 and extra == {"note": "x"}
    _assert_same_bits(restored, state)
    # without ``like``: a dict keyed by leaf path
    _, by_key, _ = ckpt.restore_checkpoint(str(tmp_path), 7, device="cpu")
    assert sorted(by_key) == sorted(k for k, _ in leaves_with_paths(state))
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    dtypes = {e["key"]: e["dtype"] for e in manifest["leaves"]}
    assert dtypes["params/embed"] == "bfloat16" and dtypes["opt/mu/embed"] == "float32"
    assert dtypes["opt/step"] == "int32"
    # a tree that does not fit the checkpoint is refused
    wrong = _state("meta")
    wrong["params"]["embed"] = torch.empty((3, 3), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="params/embed"):
        ckpt.restore_checkpoint(str(tmp_path), 7, like=wrong, device="cpu")


def test_checkpoint_keys_are_the_jax_key_paths():
    jax = pytest.importorskip("jax", reason="the key paths are the JAX package's")
    from repro.training.checkpoint import _flatten

    def to_jax(node):
        if isinstance(node, dict):
            return {k: to_jax(v) for k, v in node.items()}
        if isinstance(node, list):
            return tuple(to_jax(v) for v in node)
        return jax.ShapeDtypeStruct(tuple(node.shape), np.float32)

    state = _state("meta")
    keys, _, _ = _flatten(to_jax(state))
    assert [k for k, _ in leaves_with_paths(state)] == keys


def test_checkpoint_prunes_and_ignores_unfinished_saves(tmp_path):
    tree = {"p": torch.arange(4, dtype=torch.float32)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    assert ckpt.latest_steps(str(tmp_path)) == [3, 4]
    # a save cut short before its rename, and a directory without manifest
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_00000009.tmp" / "manifest.json").write_text("{}")
    (tmp_path / "step_00000010").mkdir()
    assert ckpt.latest_steps(str(tmp_path)) == [3, 4] and ckpt.latest_step(str(tmp_path)) == 4
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


def test_elastic_runner_resumes_without_drawing_twice(tmp_path):
    drawn = []

    def init_fn(dev):
        drawn.append(torch.device(dev).type)
        return _state(dev)

    runner = ElasticRunner(ElasticConfig(ckpt_dir=str(tmp_path), save_every=2, keep=2),
                           lambda: torch.device("cpu"), lambda dev: "step-fn")
    dev, step_fn, state, start = runner.resume_or_init(init_fn)
    assert (start, step_fn, drawn) == (0, "step-fn", ["cpu"])
    assert runner.maybe_save(1, state) is None
    assert runner.maybe_save(2, state).endswith("step_00000002")
    dev, _, state2, start2 = runner.resume_or_init(init_fn)
    assert start2 == 2 and drawn == ["cpu", "meta"] and dev.type == "cpu"
    _assert_same_bits(state2, state)
    # straggler detection
    assert not runner.observe_step_time(1.0, 1.0)
    for _ in range(5):
        trig = runner.observe_step_time(10.0, 1.0)
    assert trig


def test_train_launcher_resumes_where_it_stopped(tmp_path, capsys):
    args = ["--arch", "qwen3-1.7b", "--reduced", "--steps", "4", "--save-every", "2",
            "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    first = train.main(args)
    assert first["start"] == 0 and sorted(first["losses"]) == [0, 1, 2, 3]
    assert all(np.isfinite(v) for v in first["losses"].values())
    assert ckpt.latest_steps(str(tmp_path)) == [2, 4]
    # as if the run had died while saving step 4: the rerun takes steps 2 and 3
    os.rename(tmp_path / "step_00000004", tmp_path / "step_00000004.tmp")
    again = train.main(args)
    assert again["start"] == 2 and again["losses"] == {s: first["losses"][s] for s in (2, 3)}
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 0 loss" in out


@pytest.mark.parametrize("arch", ["whisper-medium", "paligemma-3b"])
def test_train_launcher_feeds_encoder_frames_and_prefix_embeds(tmp_path, arch):
    out = train.main(["--arch", arch, "--reduced", "--steps", "2", "--microbatch", "2",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert all(np.isfinite(v) for v in out["losses"].values())


def test_train_launcher_refuses_the_production_mesh(capsys):
    """On a world of 1 the (data=32, model=8) mesh cannot be built: exit 2,
    naming the 256 ranks it needs."""
    with pytest.raises(SystemExit) as e:
        train.main(["--arch", "qwen3-1.7b", "--production-mesh", "--device", "cpu"])
    err = capsys.readouterr().err
    assert e.value.code == 2 and "needs 256 ranks" in err and "has 1" in err


def test_train_example_trains_and_resumes(tmp_path):
    losses = train_lm.main(["--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses)) and ckpt.latest_step(str(tmp_path)) == 3
    more = train_lm.main(["--steps", "4", "--resume", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    assert len(more) == 1 and ckpt.latest_step(str(tmp_path)) == 4
