"""Which ``torch.distributed`` collectives a backend carries on CUDA tensors:
each collective DTensor uses (functional and c10d forms) runs between 2
ranks on card 0, each pair in processes of its own, and the exit codes and
results are printed (a crash kills only its pair).

    python -m repro_torch.scripts.probe_collectives [--backend gloo]
"""
import argparse
import socket
import subprocess
import sys

OPS = ("all_reduce", "all_reduce_max", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_to_all_single", "c10d_all_gather", "c10d_all_gather_into_tensor",
       "c10d_reduce_scatter_tensor")

RANK = r"""
import sys
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

rank, op, port, backend = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.cuda.set_device(0)
dist.init_process_group(backend, init_method="tcp://127.0.0.1:" + port, rank=rank, world_size=2)
x = torch.full((4, 8), float(rank + 1), device="cuda")
g = dist.group.WORLD
if op == "all_reduce":
    y = funcol.all_reduce(x, "sum", g)
elif op == "all_reduce_max":
    y = funcol.all_reduce(x, "max", g)
elif op == "all_gather_into_tensor":
    y = funcol.all_gather_tensor(x, 0, g)
elif op == "reduce_scatter_tensor":
    y = funcol.reduce_scatter_tensor(x, "sum", 0, g)
elif op == "all_to_all_single":
    y = funcol.all_to_all_single(x, None, None, g)
elif op == "c10d_all_gather":
    parts = [torch.empty_like(x) for _ in range(2)]
    dist.all_gather(parts, x)
    y = torch.cat(parts)
elif op == "c10d_all_gather_into_tensor":
    y = torch.empty((8, 8), device="cuda")
    dist.all_gather_into_tensor(y, x)
else:
    y = torch.empty((2, 8), device="cuda")
    dist.reduce_scatter_tensor(y, x)
y = funcol.wait_tensor(y) if hasattr(y, "wait") else y
torch.cuda.synchronize()
print("RESULT", tuple(y.shape), float(y.sum()), flush=True)
dist.destroy_process_group()
"""


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    """Returns {op: (exit codes of the 2 ranks, their result lines)}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args(argv)
    out = {}
    for op in OPS:
        port = str(_port())
        procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), op, port, args.backend],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        codes, lines = [], []
        for p in procs:
            try:
                text, _ = p.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            codes.append(p.returncode)
            lines += [ln for ln in text.splitlines() if ln.startswith("RESULT")]
        out[op] = (codes, lines)
        print(f"{args.backend} {op}: exit codes {codes} {lines}", flush=True)
    return out


if __name__ == "__main__":
    main()
