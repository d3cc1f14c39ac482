"""Training launcher: the elastic loop over the port's train step on a mesh
of cards (the JAX package's ``launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced --steps 3 --device cpu
    torchrun --nproc-per-node 8 ... -m repro_torch.launch.train --arch ... --production-mesh

The step runs on a ``DeviceMesh``: by default ``make_host_mesh()`` over the
launched ranks ((1, 1) on one card, where placing is the identity), or with
``--production-mesh`` the (data=32, model=8) mesh of 256 cards, which needs
a world of exactly 256 ranks (``torchrun`` sets the world in the
environment; the launcher exits 2 on any other size).  Parameters, the
optimizer state and each batch are placed by ``distributed.sharding``'s
rules and the step runs under ``use_mesh``.  Every arch of ``ARCH_IDS``
trains, the encoder-decoder one on the stream's encoder frames.

A checkpoint is written every ``--save-every`` steps under the number of
steps done, as whole tensors from rank 0, and a rerun with the same
``--ckpt-dir`` resumes from the latest one, placed by the rules again: the
resumed run takes the steps the first one had not (the JAX launcher saves
after step s under s and so runs step s again on resume).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.act_sharding import use_mesh
from repro_torch.distributed.elastic import ElasticConfig, ElasticRunner
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, production_ranks
from repro_torch.models import lm
from repro_torch.training.data import SyntheticTokenStream, to_device
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step
from repro_torch.training.tree import tree_map


def _join_launched_world(device) -> bool:
    """Join the process group ``torchrun`` describes in the environment, or
    make one of this process alone (an in-process store, no network).
    Returns whether it made a group (which the launcher then tears down)."""
    if dist.is_initialized():
        return False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    return True


def _whole(tree):
    """Every DTensor leaf gathered into the whole tensor (on every rank)."""
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t, tree)


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
                    help=f"the (data=32, model=8) mesh: needs {production_ranks()} ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the launched ranks' cards) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    created = _join_launched_world(device)
    try:
        return _train(ap, args, device)
    finally:
        if created:
            dist.destroy_process_group()


def _train(ap, args, device) -> dict:
    world = dist.get_world_size()
    if args.production_mesh and world != production_ranks():
        ap.exit(2, f"--production-mesh needs {production_ranks()} ranks (a (data=32, model=8) "
                   f"mesh of cards, launched with torchrun); this run has {world}\n")

    cfg = get_config(args.arch)
    shape = SHAPES_BY_NAME[args.shape]
    if args.reduced:
        cfg = cfg.reduced()
        shape = ShapeConfig(shape.name, 128, 8, shape.kind)
    mesh = (make_production_mesh(device_type=device.type) if args.production_mesh
            else make_host_mesh(device_type=device.type))
    if device.type == "cuda" and mesh.size() > 1:
        import torch

        device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    rank0 = dist.get_rank() == 0
    ecfg = ElasticConfig(ckpt_dir=args.ckpt_dir, save_every=args.save_every)

    def build_step(dev):
        return make_train_step(cfg, OptConfig(total_steps=args.steps),
                               microbatch=args.microbatch)

    def init_fn(dev):
        params = lm.init_params(cfg, seed=0, device=dev)
        return {"params": params, "opt": init_opt_state(params)}

    runner = ElasticRunner(ecfg, lambda: device, build_step)
    device, step_fn, state, start = runner.resume_or_init(init_fn)
    if start and rank0:
        print(f"resumed from step {start} ({args.ckpt_dir})")
    ds = SyntheticTokenStream(cfg, shape)
    params = sh.param_shardings(cfg, mesh, state["params"])
    opt = sh.opt_state_shardings(mesh, state["opt"], params)
    del state
    bspec = sh.batch_spec(cfg, mesh, shape)
    if rank0:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} (tp layout) "
              f"over {world} rank(s)")

    dts, losses = [], {}
    for step in range(start, args.steps):
        batch = sh.to_named(mesh, bspec, to_device(ds.batch_at(step), device))
        t0 = time.perf_counter()
        with use_mesh(mesh):
            loss, params, opt, stats = step_fn(params, opt, batch)
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor") else loss)
        dt = time.perf_counter() - t0
        dts.append(dt)
        losses[step] = loss
        if runner.observe_step_time(dt, float(np.median(dts))):
            print("straggler streak detected -> re-placement would trigger here")
        if (step + 1) % ecfg.save_every == 0:
            whole = _whole({"params": params, "opt": opt})
            if rank0:
                runner.maybe_save(step + 1, whole)
            del whole
        if rank0 and (step % 10 == 0 or step == args.steps - 1):
            print(f"step {step} loss {loss:.4f} dt {dt*1e3:.0f}ms")
    if rank0:
        print(f"training loop done: {args.steps} steps, "
              f"last loss {losses[args.steps - 1] if losses else 'n/a'}")
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
