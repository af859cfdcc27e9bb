"""Multi-host correction launcher — the Nextflow pipeline's role
(Ratatosk_nf/Ratatosk.nf) on torch.distributed.

Port of scripts/distributed_correct.py. Every host runs this same module with
its process id; inputs are chunk-scattered across hosts, the index is built
once (every host takes part) and loaded by all, outputs are gathered on
host 0. A single process runs the plain pipeline.

Example (2 hosts, one GPU each):
  host0: python -m ratatosk_tpu_torch.distributed_correct \\
             --coordinator host0:1234 --num-processes 2 --process-id 0 -- \\
             -s short.fq.gz -l long.fq.gz -o out
  host1: same with --process-id 1

Env-var alternative: RATATOSK_COORDINATOR / RATATOSK_NUM_PROCESSES /
RATATOSK_PROCESS_ID. The flags after `--` are the `correct` command's
(`--devices` picks each host's local GPUs).
"""

from __future__ import annotations

import argparse
import sys


def correct_opt(flags):
    """The CorrectOpt that the `correct` command builds from `flags`."""
    from ratatosk_tpu_torch import cli
    ap = argparse.ArgumentParser()
    cli._add_common(ap.add_subparsers(dest="command").add_parser("correct"),
                    correct_mode=True)
    return cli._build_opt(ap.parse_args(["correct", *flags]),
                          index_mode=False)


def main(argv=None, *, device="cuda") -> int:
    """device: where each process corrects (tests pass "cpu")."""
    ap = argparse.ArgumentParser(
        prog="python -m ratatosk_tpu_torch.distributed_correct")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0's rendezvous")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("rest", nargs=argparse.REMAINDER,
                    help="-- followed by `correct` CLI flags")
    args = ap.parse_args(argv)
    rest = [a for a in args.rest if a != "--"]

    import torch.distributed as dist

    from ratatosk_tpu_torch.parallel import distributed as D

    opt = correct_opt(rest)
    try:
        D.run_distributed_correct(opt, coordinator=args.coordinator,
                                  num_processes=args.num_processes,
                                  process_id=args.process_id, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
