"""The learner's MFU knobs from the environment — the port's copy of
``resolve_mxu`` (pytorch_distributed_tpu/utils/perf.py:163-187).  The rest
of the reference module (the perf plane: FLOPs, peaks, watermarks, the
transfer audit) waits for its own slice (ROADMAP.md Queue A).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

_MXU_PREFIX = "TPU_APEX_MXU_"


def resolve_mxu(lp=None):
    """``LearnerPerfParams`` with the ``TPU_APEX_MXU_<FIELD>`` overrides of
    the environment applied (``TPU_APEX_MXU_MEGABATCH``,
    ``TPU_APEX_MXU_PALLAS_TORSO``); a new instance, the input is not
    changed.  Spawn children inherit the environment, so every process
    resolves the same knobs."""
    from pytorch_distributed_tpu_torch.config import LearnerPerfParams

    if lp is None:
        lp = LearnerPerfParams()
    changes: Dict[str, Any] = {}
    for f in dataclasses.fields(lp):
        raw = os.environ.get(_MXU_PREFIX + f.name.upper())
        if raw is None:
            continue
        if isinstance(getattr(lp, f.name), bool):
            changes[f.name] = raw.strip().lower() not in (
                "0", "false", "off", "no", "")
        else:
            changes[f.name] = int(float(raw))
    return dataclasses.replace(lp, **changes) if changes else lp
