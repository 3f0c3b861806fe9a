"""Entry point of the port — the counterpart of the repository's root
``main.py`` (:22-121) for the rows this port runs.

    python -m pytorch_distributed_tpu_torch.main --config 12 \\
        [--backend process|thread] [--device cuda|cpu] [--set k=v ...]
    python -m pytorch_distributed_tpu_torch.main --config 12 \\
        --resume REFS [--steps N] [--set k=v ...]
    python -m pytorch_distributed_tpu_torch.main --config 12 --mode 2 \\
        --model-file models/REFS [--device cpu]

Both modes run on the GPU unless ``--device cpu`` is given; with no GPU
visible and no ``--device cpu`` they raise.  Mode 1 trains (the process
backend by default); scalars land in ``logs/{refs}/scalars.jsonl`` and
params checkpoints in ``models/{refs}.pt`` (and ``models/{refs}_best.pt``)
under ``root_dir`` (the working directory unless ``--set root_dir=...``),
and every run ends by committing a checkpoint epoch under
``models/{refs}_ckpt`` (more often with ``--set checkpoint_freq=N``).  A
run under the refs of an earlier one continues from its newest complete
epoch; ``--resume REFS`` insists on one.  SIGTERM ends a run early with
a final epoch and exit code 0.  Mode 2 runs the tester's greedy episodes on a params file.  The last line
printed is the run's summary (mode 1) or the tester's stats (mode 2) as
one JSON object.
"""

from __future__ import annotations

import argparse
import json

from pytorch_distributed_tpu_torch.config import (
    CONFIGS, build_options, parse_set_overrides,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=int, default=12,
                   help=f"CONFIGS row 0..{len(CONFIGS) - 1}")
    p.add_argument("--mode", type=int, default=1, choices=(1, 2),
                   help="1=train, 2=test a checkpoint")
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--num-actors", type=int, default=None)
    p.add_argument("--num-envs-per-actor", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--memory-size", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--nstep", type=int, default=None)
    p.add_argument("--enable-double", action="store_true")
    p.add_argument("--publish-freq", type=int, default=None,
                   help="learner steps between param publications")
    p.add_argument("--model-file", type=str, default=None,
                   help="the params checkpoint mode 2 tests")
    p.add_argument("--resume", type=str, default=None, metavar="REFS",
                   help="continue run REFS from its newest complete "
                        "checkpoint epoch (models/REFS_ckpt); raises if "
                        "there is none")
    p.add_argument("--backend", choices=("process", "thread"),
                   default="process")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="any Options override, e.g. --set lr=2e-3 "
                        "(repeatable)")
    return p.parse_args(argv)


def options_from_args(args):
    overrides = dict(mode=args.mode, seed=args.seed, device=args.device)
    overrides.update(parse_set_overrides(args.set))
    flags = dict(num_actors=args.num_actors,
                 num_envs_per_actor=args.num_envs_per_actor,
                 steps=args.steps, memory_size=args.memory_size,
                 batch_size=args.batch_size, nstep=args.nstep,
                 param_publish_freq=args.publish_freq,
                 model_file=args.model_file)
    overrides.update({k: v for k, v in flags.items() if v is not None})
    if args.resume is not None:
        overrides.update(refs=args.resume, resume="must")
    if args.enable_double:
        overrides["enable_double"] = True
    return build_options(config=args.config, **overrides)


def main(argv=None):
    args = parse_args(argv)
    opt = options_from_args(args)
    from pytorch_distributed_tpu_torch import runtime

    if opt.mode == 2:
        summary = runtime.test(opt)
    else:
        print(f"[main] training config {args.config} ({opt.agent_type}/"
              f"{opt.env_type}/{opt.game}/{opt.memory_type}/"
              f"{opt.model_type}) on {opt.device}, {args.backend} backend "
              f"-> {opt.refs}", flush=True)
        summary = runtime.train(opt, backend=args.backend)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
