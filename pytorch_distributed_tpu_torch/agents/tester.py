"""Tester: mode-2 evaluation of a saved checkpoint — the port of
pytorch_distributed_tpu/agents/tester.py ``run_tester`` (:24-49).

Loads the params file named by ``model_file`` (``models/{refs}`` or a
path ending in ``.pt``), runs ``tester_nepisodes`` greedy episodes in
``env.eval()`` mode with inference on the run's device (the GPU unless
``device`` is ``cpu``; with no GPU visible it raises), prints
``avg_steps / avg_reward / nepisodes / nepisodes_solved`` and returns
them.
"""

from __future__ import annotations

from typing import Dict

from pytorch_distributed_tpu_torch.agents.evaluator import greedy_episodes
from pytorch_distributed_tpu_torch.config import Options
from pytorch_distributed_tpu_torch.factory import (
    EnvSpec, build_env, build_model, resolve_device,
)
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt


def run_tester(opt: Options, spec: EnvSpec) -> Dict[str, float]:
    ap = opt.agent_params
    device = resolve_device(opt)
    env = build_env(opt, process_ind=0)
    env.eval()
    model = build_model(opt, spec)
    path = opt.model_file
    if not path:
        raise ValueError("mode 2 needs model_file")
    if not path.endswith(ckpt.EXT):
        path = ckpt.params_path(path)
    params = ckpt.load_params(path)
    avg_steps, avg_reward, solved = greedy_episodes(
        opt, spec, model, params, env, ap.tester_nepisodes, device)
    out = {
        "avg_steps": avg_steps,
        "avg_reward": avg_reward,
        "nepisodes": float(ap.tester_nepisodes),
        "nepisodes_solved": float(solved),
    }
    print(f"[tester] {out}", flush=True)
    return out
