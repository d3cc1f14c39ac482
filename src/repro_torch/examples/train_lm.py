"""Training example: train the JAX package's ``examples/train_lm.py`` model,
a small qwen3-family one (4.5M parameters by ``param_count()``), for a few
hundred steps on the synthetic token stream, with checkpoint/restart.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]

A checkpoint is saved every 100 steps and at the end, under the number of
steps done; ``--resume`` continues from the latest one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.training.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.training.data import SyntheticTokenStream, to_device
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> list:
    """Returns the losses of the steps it ran."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_example"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (one card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("qwen3-1.7b").reduced(
        d_model=256, d_ff=1024, n_heads=8, d_head=32, vocab_size=2048,
        n_layers=4,
        segments=tuple(
            s for s in get_config("qwen3-1.7b").reduced().segments
        ) * 4,
    )
    shape = ShapeConfig("example", seq_len=128, global_batch=8, kind="train")
    print(f"model: {cfg.param_count()/1e6:.1f}M params")

    params = lm.init_params(cfg, seed=0, device=device)
    opt = init_opt_state(params)
    start = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start, state, _ = restore_checkpoint(
            args.ckpt_dir, like={"params": params, "opt": opt}, device=device)
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    step_fn = make_train_step(cfg, OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps))
    ds = SyntheticTokenStream(cfg, shape)
    t0 = time.perf_counter()
    losses = []
    for step in range(start, args.steps):
        loss, params, opt, stats = step_fn(params, opt, to_device(ds.batch_at(step), device))
        losses.append(float(loss))
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"lr {float(stats['lr']):.2e} "
                  f"gnorm {float(stats['grad_norm']):.2f} "
                  f"({(time.perf_counter()-t0):.1f}s)")
        if (step + 1) % 100 == 0:
            save_checkpoint(args.ckpt_dir, step + 1, {"params": params, "opt": opt})
    save_checkpoint(args.ckpt_dir, args.steps, {"params": params, "opt": opt})
    print("done; checkpoint saved")
    return losses


if __name__ == "__main__":
    main()
