"""Collective profile of one cell: trace one step on the production mesh
(a fake world, as ``launch.dryrun``) and print the largest collectives by
op, operand shape and dtype, and the mesh dim they cross.

    PYTHONPATH=src python -m repro_torch.scripts.inspect_collectives \\
        --arch qwen3-1.7b --shape train_4k [--layers 1]

``--layers`` cuts every segment to that many layers (a faster trace; the
per-layer pattern is the same).
"""
import argparse
import dataclasses

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh, production_ranks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--shape", required=True, choices=list(SHAPES_BY_NAME))
    ap.add_argument("--layout", default="tp", choices=["tp", "serve_tp", "dp_only"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut every segment to this many layers (0: full depth)")
    ap.add_argument("--device-type", default=None, choices=[None, "cpu", "cuda"])
    ap.add_argument("--top", type=int, default=14)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        segs = tuple(dataclasses.replace(s, repeat=min(s.repeat, args.layers))
                     for s in cfg.segments)
        enc = tuple(dataclasses.replace(s, repeat=min(s.repeat, args.layers))
                    for s in cfg.encoder_segments)
        cfg = dataclasses.replace(cfg, segments=segs, n_layers=sum(s.repeat for s in segs),
                                  encoder_segments=enc,
                                  n_encoder_layers=sum(s.repeat for s in enc))
    shape = SHAPES_BY_NAME[args.shape]
    dryrun.init_fake_world(production_ranks())
    mesh = make_production_mesh(device_type=args.device_type)
    tr = dryrun.trace_step(cfg, shape, mesh, layout=args.layout)
    events = tr["collective_events"]
    rows = sorted(events.items(), key=lambda kv: -kv[0][4] * kv[1])
    total = sum(key[4] * n for key, n in events.items())
    print(f"{args.arch} {args.shape} ({cfg.n_layers} layers, {args.layout}): "
          f"collective operand bytes per device {total / 1e9:.3f} GB")
    for (op, shp, dtype, axis, nbytes), n in rows[: args.top]:
        print(f"{n:4d}x {nbytes / 1e6:9.1f}MB {op:15s} {axis:6s} {str(shp):28s} {dtype}")


if __name__ == "__main__":
    main()
