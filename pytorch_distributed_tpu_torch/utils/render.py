"""Headless rendering: env frames dumped as PNG files — the port of
pytorch_distributed_tpu/utils/render.py (:20-73): ``frame_image``,
``attach_frame_dumper`` and ``FrameDumper``.  Attach a ``FrameDumper``
to an env (``env.attach_renderer``) and each ``env.render()`` writes the
newest observation frame to ``<dir>/ep<episode>/step<t>.png``;
``main --render`` (``env_params.render``) attaches one to the evaluator's
and the tester's env under ``{log_dir}/frames``.

The reference writes the PNG with PIL; the port encodes it itself
(``encode_png``: zlib and struct, 8-bit grey or RGB, no filter), so the
dump needs no package that a host may lack.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np


def frame_image(obs: np.ndarray) -> Optional[np.ndarray]:
    """The newest displayable (H, W) or (H, W, 3) uint8 frame of an
    observation, or None for one that is not an image."""
    obs = np.asarray(obs)
    if obs.dtype != np.uint8:
        return None
    if obs.ndim == 2:
        return obs
    if obs.ndim == 3:
        if obs.shape[-1] == 3:  # already (H, W, RGB)
            return obs
        return obs[-1]  # a (C, H, W) frame stack: the newest frame last
    return None


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W) grey or (H, W, 3) RGB uint8 image as PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 0 if img.ndim == 2 else 2
    # every scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, -1)], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def attach_frame_dumper(env, log_dir: str, role: str) -> str:
    """Attach a ``FrameDumper`` under ``<log_dir>/frames`` to ``env`` and
    say so; returns the directory."""
    frames_dir = os.path.join(log_dir, "frames")
    env.attach_renderer(FrameDumper(frames_dir))
    print(f"[{role}] rendering eval frames to {frames_dir}", flush=True)
    return frames_dir


class FrameDumper:
    def __init__(self, root: str):
        self.root = root
        self.episode = -1
        self.t = 0
        os.makedirs(root, exist_ok=True)

    def new_episode(self) -> None:
        self.episode += 1
        self.t = 0
        os.makedirs(self._ep_dir(), exist_ok=True)

    def _ep_dir(self) -> str:
        return os.path.join(self.root, f"ep{self.episode:03d}")

    def add(self, obs: np.ndarray) -> Optional[str]:
        """Write the observation's newest frame; returns the path (None
        for an observation that is not an image)."""
        img = frame_image(obs)
        if img is None:
            return None
        if self.episode < 0:
            self.new_episode()
        path = os.path.join(self._ep_dir(), f"step{self.t:05d}.png")
        with open(path, "wb") as f:
            f.write(encode_png(img))
        self.t += 1
        return path
