"""Offline check of a checkpoint root — the port's counterpart of
``tools/ckpt_fsck.py``:

    python -m pytorch_distributed_tpu_torch.ckpt_fsck models/REFS_ckpt [--json]

Prints one line per epoch (status, learner step, bytes per artifact) and
every violation, or the report as JSON with ``--json``.  Exits 0 when the
root is resumable (a complete epoch and no violation), 1 otherwise.  It
reads roots the JAX package wrote too.
"""

from __future__ import annotations

import argparse
import json
import sys

from pytorch_distributed_tpu_torch.utils.checkpoint import fsck


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", help="a checkpoint root, models/REFS_ckpt")
    p.add_argument("--json", action="store_true",
                   help="print the report as one JSON object")
    args = p.parse_args(argv)
    report = fsck(args.root)
    ok = report["newest_complete"] is not None and not report["violations"]
    if args.json:
        print(json.dumps(dict(report, resumable=ok)))
    else:
        for e in report["epochs"]:
            arts = ", ".join(f"{k} {v} B"
                             for k, v in e.get("artifacts", {}).items())
            print(f"epoch {e['epoch']}: {e['status']}"
                  + (f", step {e['learner_step']}" if "learner_step" in e
                     else "") + (f" ({arts})" if arts else ""))
        for v in report["violations"]:
            print(f"VIOLATION: {v}")
        print(f"{args.root}: "
              + (f"resumable from epoch {report['newest_complete']}" if ok
                 else "NOT resumable"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
