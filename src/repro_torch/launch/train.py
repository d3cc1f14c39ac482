"""Training launcher: the elastic loop over the port's train step (the JAX
package's ``launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced --steps 3 --device cpu

Runs on one card by default (``--device cpu`` runs on the CPU); every arch
of ``ARCH_IDS`` trains, the encoder-decoder one on the stream's encoder
frames.  A checkpoint is written every ``--save-every`` steps under the
number of steps done, and a rerun with the same ``--ckpt-dir`` resumes from
the latest one: the resumed run takes the steps the first one had not (the
JAX launcher saves after step s under s and so runs step s again on
resume).  ``--production-mesh`` exits 2: sharding over a mesh of cards is
ROADMAP.md queue A item 7, and the launcher does not train unsharded in its
place.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.elastic import ElasticConfig, ElasticRunner
from repro_torch.models import lm
from repro_torch.training.data import SyntheticTokenStream, to_device
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step


def main(argv=None) -> dict:
    """Returns {"start": the step it began at, "losses": {step: loss}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES_BY_NAME))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_launch_train"))
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true",
                    help="not available: sharding is ROADMAP.md queue A item 7")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card) or cpu")
    args = ap.parse_args(argv)
    if args.production_mesh:
        ap.exit(2, "--production-mesh: sharding over a mesh of cards is not ported yet "
                   "(ROADMAP.md queue A item 7); the launcher trains on one device\n")

    cfg = get_config(args.arch)
    shape = SHAPES_BY_NAME[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig(shape.name, 128, 8, shape.kind)
    device = resolve_device(args.device)
    ecfg = ElasticConfig(ckpt_dir=args.ckpt_dir, save_every=args.save_every)

    def build_step(dev):
        return make_train_step(cfg, OptConfig(total_steps=args.steps),
                               microbatch=args.microbatch)

    def init_fn(dev):
        params = lm.init_params(cfg, seed=0, device=dev)
        return {"params": params, "opt": init_opt_state(params)}

    runner = ElasticRunner(ecfg, lambda: device, build_step)
    device, step_fn, state, start = runner.resume_or_init(init_fn)
    if start:
        print(f"resumed from step {start} ({args.ckpt_dir})")
    ds = SyntheticTokenStream(cfg, shape)
    params, opt = state["params"], state["opt"]

    dts, losses = [], {}
    for step in range(start, args.steps):
        batch = to_device(ds.batch_at(step), device)
        t0 = time.perf_counter()
        loss, params, opt, stats = step_fn(params, opt, batch)
        loss = float(loss)  # waits for the step
        dt = time.perf_counter() - t0
        dts.append(dt)
        losses[step] = loss
        if runner.observe_step_time(dt, float(np.median(dts))):
            print("straggler streak detected -> re-placement would trigger here")
        runner.maybe_save(step + 1, {"params": params, "opt": opt})
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step} loss {loss:.4f} dt {dt*1e3:.0f}ms")
    print(f"training loop done: {args.steps} steps, "
          f"last loss {losses[args.steps - 1] if losses else 'n/a'}")
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
