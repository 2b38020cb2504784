"""The collective paths of ranks that share a card.

Four ranks (``core.distributed.run_ranks``, all on cuda:0) as a (2, 2)
('data', 'model') mesh try each collective a partitioned step issues, as
DTensor issues it (functional collectives, and DTensor's shard-to-shard
all-to-all), on CUDA tensors, by each path of ``--backends``: ``gloo`` as
it is; ``staged``, gloo with every CUDA tensor copied to the host and
back (this script's own ``_stage``); ``shared``, the port's path
(``core.distributed.share_collectives``: buffers mapped by CUDA IPC, gloo
barriers). One mesh a collective, so that one that kills a rank hides no
other; then, but for ``gloo`` (whose all-gather of CUDA tensors is the
fault), an all-gather of ``--mb`` MiB a rank is timed. Prints a JSON line
per try and one with them all: per collective, "ok" with its seconds and
whether the result is right, or the error. Run on the card:

  python tools/gloo_cuda_probe.py
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _stage():
    """gloo with each functional collective's CUDA tensor copied to the
    host, the op's CPU kernel run there, and the result copied back."""
    libs = []
    for ns, name in (("_c10d_functional", "all_reduce"),
                     ("_c10d_functional", "all_gather_into_tensor"),
                     ("_c10d_functional", "reduce_scatter_tensor"),
                     ("_c10d_functional", "all_to_all_single"),
                     ("_dtensor", "shard_dim_alltoall")):
        op = getattr(getattr(torch.ops, ns), name).default

        def impl(input, *rest, op=op):
            out = op(input.detach().to("cpu"), *rest)
            return torch.ops._c10d_functional.wait_tensor(out).to(input.device)

        lib = torch.library.Library(ns, "IMPL")
        lib.impl(name, impl, "CUDA")
        libs.append(lib)
    return libs


def _tries(x, g):
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor._collective_utils import shard_dim_alltoall

    return {
        "all_reduce": lambda: funcol.all_reduce(x, "sum", g),
        "all_gather_into_tensor": lambda: funcol.all_gather_tensor(x, 0, g),
        "reduce_scatter_tensor": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, g),
        "all_to_all_single": lambda: funcol.all_to_all_single(x, None, None, g),
        "shard_dim_alltoall": lambda: shard_dim_alltoall(x, 0, 1, g[0], g[1]),
    }


def _want(name, rank):
    """What rank ``rank`` gets: the 'data' group of rank r is {r % 2, r % 2 + 2},
    each member's x filled with its rank."""
    a, b = rank % 2, rank % 2 + 2
    mine = torch.full((4, 8), float(rank))
    both = torch.cat([torch.full((4, 8), float(a)), torch.full((4, 8), float(b))])
    if name == "all_reduce":
        return torch.full((4, 8), float(a + b))
    if name == "all_gather_into_tensor":
        return both
    if name == "reduce_scatter_tensor":
        return torch.full((2, 8), float(a + b))
    if name == "all_to_all_single":
        return torch.cat([both[0:2], both[4:6]]) if rank < 2 else torch.cat(
            [both[2:4], both[6:8]])
    # shard_dim_alltoall: gathered on dim 0, this rank's half of dim 1
    return torch.cat([torch.full((4, 4), float(a)), torch.full((4, 4), float(b))])


def _probe(rank, device_mesh, mb, only, staged=False):
    from torch.distributed import _functional_collectives as funcol

    if only == "mesh":
        return {"mesh": str(device_mesh)}
    libs = _stage() if staged else []  # noqa: F841 (kept for the process)
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((4, 8), float(rank), device=dev)
    g = (device_mesh, 0)
    out = {}
    for name, fn in _tries(x, g).items():
        if only is not None and name != only:
            continue
        print(f"rank {rank}: {name}", file=sys.stderr, flush=True)
        try:
            t0 = time.perf_counter()
            y = fn()
            if isinstance(y, funcol.AsyncCollectiveTensor):
                y = y.wait()
            torch.cuda.synchronize(dev)
            out[name] = {"ok": True, "s": time.perf_counter() - t0,
                         "device": str(y.device), "shape": list(y.shape),
                         "right": bool(torch.equal(y.cpu(), _want(name, rank)))}
        except Exception as e:  # the probe's answer
            out[name] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:400]}
    if only is not None:
        return out
    big = torch.ones(mb * 2**18, device=dev)
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        y = funcol.all_gather_tensor(big, 0, g)
        if isinstance(y, funcol.AsyncCollectiveTensor):
            y = y.wait()
        torch.cuda.synchronize(dev)
        out[f"all_gather_{mb}MiB_s"] = time.perf_counter() - t0
    return out


def main():
    from repro_torch.core.distributed import run_ranks

    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=96)
    ap.add_argument("--backends", default="gloo,staged,shared")
    args = ap.parse_args()
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}
    names = ("mesh", "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "shard_dim_alltoall")
    for path in args.backends.split(","):
        for name in names + (None,):
            key = f"{path}/{name or 'timing'}"
            if name is None and path == "gloo":
                continue            # gloo's own all-gather of CUDA tensors is the fault
            try:
                res = run_ranks(_probe, (2, 2), ("data", "model"), device="cuda",
                                backend="gloo" if path == "staged" else path,
                                args=(args.mb, name, path == "staged"), timeout=300)
                out[key] = res
            except Exception as e:  # the probe's answer
                out[key] = f"{type(e).__name__}: {e}"[-1500:]
            print(json.dumps({key: out[key]}), flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
