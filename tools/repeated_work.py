"""How much work the ranks of a partitioned step repeat, from walks on the CPU.

For each arch (reduced width; ``--layers`` cuts depth), rank 0's steps are
walked on a fake (2, 2) ('data', 'model') process group and on one device
(``launch.partitioned.predict(..., whole=True)``); the line printed gives
each step's 4 × rank 0's flops over one device's
(``launch.partitioned.repeated_work``: 1 when no rank repeats another's
work), each step's collective count, the train step's named replicated
flops and its largest intermediate:

    PYTHONPATH=src python tools/repeated_work.py
    PYTHONPATH=src python tools/repeated_work.py xlstm_350m --layers 5
"""

from __future__ import annotations

import argparse
import json

from repro_torch.core.distributed import run_isolated
from repro_torch.launch import partitioned as P

ARCHS = ["minicpm_2b", "granite_moe_3b_a800m", "xlstm_350m", "zamba2_7b",
         "seamless_m4t_medium"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("archs", nargs="*", default=ARCHS)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    args = ap.parse_args(argv)
    over = {"num_classes": 8}
    if args.layers:
        over["num_layers"] = args.layers
    for arch in args.archs:
        plan = P.Plan(arch, reduced=over, batch=args.batch, seq=args.seq, decode=1)
        rec = run_isolated(P.predict, [plan], (2, 2), ("data", "model"), "cpu",
                           whole=True, timeout=1800)[0]
        steps = rec["steps"]
        print(json.dumps({
            "arch": arch,
            "repeated": P.repeated_work(rec, 4),
            "collectives": {k: len(v["collectives"]) for k, v in steps.items()},
            "replicated_flops": steps["train"]["cost"]["replicated"],
            "largest": steps["train"]["cost"]["peak_aval_shape"]}), flush=True)


if __name__ == "__main__":
    main()
