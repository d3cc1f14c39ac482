"""Production-mesh dry-run: trace one step of every (arch x shape) cell on a
fake world of 256 or 512 ranks, and record memory, FLOPs, collectives and a
roofline (the JAX package's ``launch/dryrun.py``).

A process holds one ``"fake"`` process group (``FakeStore``) of the
production mesh's size, which moves no data, and runs under
``FakeTensorMode``, which allocates nothing.  The stand-ins of
``launch.specs`` are placed on the mesh by ``distributed.sharding``'s rules
as DTensors, so each rank's tensors have its local shard's shape, and one
step of ``specs.make_step_fn`` runs on them under ``use_mesh``:

* memory: argument and output bytes are this rank's shard bytes
  (``sharding.local_bytes``); the peak and the temporaries come from
  ``MemTracker``;
* costs: per-device FLOPs, op bytes and collectives from
  ``analysis.costs.CostMode`` over the full-depth step (every layer runs, so
  nothing is extrapolated);
* roofline: ``analysis.costs.roofline_terms`` (H100 data-sheet figures) with
  the memory term from ``analysis.memory_model.analytic_hbm_bytes``, and the
  check against the card's 80 GB.

The fake group is process-wide, so one process runs one mesh kind:

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-1.7b --shape train_4k --mesh single \\
        --out results/dryrun/qwen3-1.7b.train_4k.single.json

``--mesh both`` runs each kind in a subprocess of its own.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import costs as C
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config, shape_applicable
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh, production_ranks
from repro_torch.training.tree import leaves, tree_map


def init_fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks for this process (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"this process already holds a group of {dist.get_world_size()} "
                               f"ranks; the dry-run needs {world}: run it in a fresh process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _materialize(tree, device):
    """Meta stand-ins -> fake tensors on ``device`` (under FakeTensorMode)."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), tree)


def _place_inputs(cfg, shape, mesh, ispec, device, layout):
    """The step's arguments placed on the mesh by the rules."""
    params = sh.param_shardings(cfg, mesh, _materialize(ispec["params"], device), layout)
    if shape.kind == "train":
        opt = _materialize(ispec["opt_state"], device)
        opt = sh.opt_state_shardings(mesh, opt, params)
        batch = sh.to_named(mesh, sh.batch_spec(cfg, mesh, shape, layout),
                            _materialize(ispec["batch"], device))
        return params, opt, batch
    if shape.kind == "prefill":
        bspec = sh.batch_spec(cfg, mesh, shape, layout)
        batch = sh.to_named(mesh, {k: bspec[k] for k in ispec["batch"]},
                            _materialize(ispec["batch"], device))
        return params, batch
    state = sh.decode_state_shardings(cfg, mesh, shape.global_batch,
                                      _materialize(ispec["state"], device), layout)
    tokens = sh.place(mesh, _materialize(ispec["tokens"], device),
                      sh.tokens_spec(mesh, shape.global_batch, layout))
    return params, tokens, state


def _storages(tree) -> set:
    out = set()
    for t in leaves(tree) if isinstance(tree, (dict, list, tuple)) else [tree]:
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            out.add(local.untyped_storage()._cdata)
    return out


def _alias_bytes(args, out) -> int:
    """Bytes of outputs that are arguments updated in place."""
    arg_st = _storages(list(args))
    total = 0
    for t in leaves(list(out)):
        local = t.to_local() if hasattr(t, "to_local") else t
        if local.untyped_storage()._cdata in arg_st:
            total += local.numel() * local.element_size()
    return total


def trace_step(cfg, shape, mesh, *, microbatch: int = 0, layout: str = "tp",
               device=None) -> dict:
    """One step of the cell on fake tensors: its memory and costs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.distributed.act_sharding import use_mesh

    device = torch.device(device or mesh.device_type)
    with FakeTensorMode():
        ispec = S.input_specs(cfg, shape)
        args = _place_inputs(cfg, shape, mesh, ispec, device, layout)
        step = S.make_step_fn(cfg, shape, microbatch=microbatch)
        arg_bytes = sh.local_bytes(list(args))
        mt = MemTracker()
        mt.track_external(*[t.to_local() for t in leaves(list(args))
                            if hasattr(t, "to_local")])
        cm = C.CostMode.for_mesh(mesh)
        t0 = time.perf_counter()
        with use_mesh(mesh, layout), C.without_shape_inference(), mt, cm:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        peak = max((snap.get("Total", 0) for snap in mt.get_tracker_snapshot("peak").values()),
                   default=0)
        out_bytes = sh.local_bytes(list(out))
        alias = _alias_bytes(args, out)
    temp = max(peak - arg_bytes, 0)
    return {
        "trace_s": trace_s,
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": temp,
            "alias_bytes": alias,
            "peak_bytes_tracked": peak,
            "peak_bytes_est": arg_bytes + out_bytes + temp - alias,
        },
        "costs": cm.costs(),
        "collective_events": dict(cm.collective_events),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             microbatch: int = 0, skip_cost: bool = False,
             overrides: dict | None = None, layout: str = "tp",
             device_type: str | None = None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "applicable": ok, "reason": reason,
        "microbatch": microbatch, "overrides": overrides or {}, "layout": layout,
    }
    if not ok:
        return rec

    multi = mesh_kind == "multi"
    init_fake_world(production_ranks(multi))
    mesh = make_production_mesh(multi_pod=multi, device_type=device_type)
    chips = mesh.size()
    rec["chips"] = chips
    rec["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))

    tr = trace_step(cfg, shape, mesh, microbatch=microbatch, layout=layout)
    costs = tr["costs"]
    rec["compile_s"] = tr["trace_s"]  # the JAX record's key: here the trace's time
    rec["memory"] = tr["memory"]
    rec["scan_level_costs"] = {
        "flops_per_device": costs.flops_per_device,
        "bytes_per_device": costs.bytes_per_device,
        "collective_bytes": costs.collectives.total_bytes,
        "collective_counts": costs.collectives.count_by_op,
        "collective_bytes_by_op": costs.collectives.bytes_by_op,
        "collective_bytes_by_axis": costs.collectives.bytes_by_axis,
    }
    rec["cost_variants"] = {"method": "full-depth trace: every layer's local ops counted, "
                                      "no depth extrapolation",
                            "layers": cfg.n_layers + cfg.n_encoder_layers}
    if multi or skip_cost:
        return rec  # the multi-pod pass only proves the pod axis shards

    from repro_torch.analysis.memory_model import analytic_hbm_bytes

    rec["roofline"] = C.roofline_terms(costs, chips)
    tp = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1) \
        if layout in ("tp", "serve_tp") else 1
    mem = analytic_hbm_bytes(cfg, shape, chips, tp=tp)
    rec["roofline"]["analytic_hbm_bytes"] = mem
    rec["roofline"]["t_memory_s"] = mem["total"] / C.HBM_BW
    rec["roofline"]["t_memory_op_bytes_upper_s"] = costs.bytes_per_device / C.HBM_BW
    terms = {"compute": rec["roofline"]["t_compute_s"],
             "memory": rec["roofline"]["t_memory_s"],
             "collective": rec["roofline"]["t_collective_s"]}
    rec["roofline"]["dominant"] = max(terms, key=terms.get)
    rec["model"] = C.model_flops(cfg, shape, chips)
    mfpd = rec["model"]["model_flops_per_device"]
    rec["roofline"]["useful_flops_ratio"] = (
        mfpd / costs.flops_per_device if costs.flops_per_device else 0.0
    )
    rec["roofline"]["fits_hbm"] = rec["memory"]["peak_bytes_est"] <= C.HBM_BYTES
    rec["roofline"]["roofline_frac_of_dominant"] = None  # filled by report
    return rec


def run_cell_subprocess(arch: str, shape_name: str, mesh_kind: str, *, timeout: float = 3600,
                        **kw) -> dict:
    """``run_cell`` in a fresh interpreter (the fake group is process-wide)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rec.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape_name, "--mesh", mesh_kind, "--out", out, "--quiet",
               "--layout", kw.get("layout", "tp"), "--microbatch", str(kw.get("microbatch", 0))]
        if kw.get("skip_cost"):
            cmd.append("--skip-cost")
        if kw.get("overrides"):
            cmd += ["--overrides", json.dumps(kw["overrides"])]
        if kw.get("device_type"):
            cmd += ["--device-type", kw["device_type"]]
        env = dict(os.environ)
        src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env)
        if p.returncode != 0 or not os.path.exists(out):
            return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "error": f"exit {p.returncode}", "traceback": p.stderr[-4000:]}
        with open(out) as f:
            return json.load(f)[0]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES_BY_NAME))
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--skip-cost", action="store_true")
    ap.add_argument("--layout", default="tp", choices=list(sh.LAYOUTS))
    ap.add_argument("--overrides", type=str, default="",
                    help="JSON dict of ModelConfig overrides (perf experiments)")
    ap.add_argument("--device-type", default=None, choices=[None, "cpu", "cuda"],
                    help="the fake tensors' device (default: cuda where a card is)")
    ap.add_argument("--out", default="")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    overrides = json.loads(args.overrides) if args.overrides else None
    kw = dict(microbatch=args.microbatch, skip_cost=args.skip_cost, overrides=overrides,
              layout=args.layout, device_type=args.device_type)
    out = []
    if args.mesh == "both":
        out = [run_cell_subprocess(args.arch, args.shape, mk, **kw) for mk in ("single", "multi")]
    else:
        try:
            out = [run_cell(args.arch, args.shape, args.mesh, **kw)]
        except Exception as e:  # noqa: BLE001
            out = [{"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
                    "error": repr(e), "traceback": traceback.format_exc()}]
    if not args.quiet:
        for rec in out:
            print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                             indent=2, default=str))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, default=str)


if __name__ == "__main__":
    main()
