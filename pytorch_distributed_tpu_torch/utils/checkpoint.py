"""Params-only checkpoints — the port of the params tier of
pytorch_distributed_tpu/utils/checkpoint.py (``save_params``,
``load_params``, ``params_path``, ``save_best_score``,
``load_best_score``, :108-160).

The files are the port's own: ``torch.save`` of the model's state_dict
(fp32 CPU tensors) at ``{model_name}.pt``, with the reference's path
scheme (``models/{refs}``) and its ``_best`` tier: ``{model_name}_best.pt``
holds the weights of the highest evaluation so far, and the sidecar
``{model_name}_best.json`` the score they earned.  Every write goes to a
temporary file first and is renamed into place, so a reader never sees a
torn file.  The reference's ``.msgpack`` files are not read.  The epoch
tier and resume are not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

EXT = ".pt"


def _replace_atomic(path: str, write) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)
    return path


def save_params(path: str, params: Dict[str, torch.Tensor]) -> str:
    """Write a params-only checkpoint.  Returns the path."""
    cpu = {k: v.detach().to("cpu", torch.float32) for k, v in params.items()}
    return _replace_atomic(path, lambda tmp: torch.save(cpu, tmp))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def params_path(model_name: str) -> str:
    """``models/{refs}.pt``: the reference's scheme with the port's
    extension."""
    return model_name + EXT


def best_score_path(model_name: str) -> str:
    return model_name + "_best.json"


def save_best_score(model_name: str, reward: float,
                    step: Optional[int] = None) -> None:
    """The score the ``_best`` weights earned; written before the weights,
    so a crash between the two leaves the threshold ahead of the file and
    never lets a worse policy overwrite a better one."""

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump({"best_eval_reward": float(reward), "step": step}, f)

    _replace_atomic(best_score_path(model_name), write)


def load_best_score(model_name: str) -> float:
    """The sidecar's score; -inf when absent or unreadable."""
    try:
        with open(best_score_path(model_name)) as f:
            return float(json.load(f)["best_eval_reward"])
    except (OSError, ValueError, KeyError):
        return float("-inf")
