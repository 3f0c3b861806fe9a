"""Vector env — the port's copy of pytorch_distributed_tpu/envs/vector.py.

N independent envs stepped as one batch.  When env j terminates, ``step``
returns its reset observation and stashes the true terminal observation in
``infos[j]["final_obs"]`` so the n-step assembler sees the real boundary.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np


class VectorEnv:
    def __init__(self, envs: Sequence[Any]):
        if not envs:
            raise ValueError("need at least one env")
        self.envs = list(envs)
        self.num_envs = len(self.envs)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     List[Dict[str, Any]]]:
        obs_out, rewards, terminals, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            obs, r, term, info = e.step(a)
            if term:
                info = dict(info)
                info["final_obs"] = obs
                obs = e.reset()
            obs_out.append(obs)
            rewards.append(r)
            terminals.append(term)
            infos.append(info)
        return (np.stack(obs_out),
                np.asarray(rewards, dtype=np.float32),
                np.asarray(terminals, dtype=bool),
                infos)
