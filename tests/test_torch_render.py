"""The port's frame dumps (utils/render.py) against the JAX package's
(which writes with PIL): the PNG the port encodes itself decodes to the
same pixels as the reference's file for the same frames, grey and RGB;
the dumper's directory layout is the reference's; the evaluator's
episodes render every step; and ``main --mode 2 --render`` writes the
tester's frames under ``logs/{refs}/frames``."""

import glob
import os
import tempfile

import numpy as np
import pytest
from PIL import Image

from pytorch_distributed_tpu.utils import render as jrender
from pytorch_distributed_tpu_torch import main as port_main
from pytorch_distributed_tpu_torch.utils import checkpoint as ckpt
from pytorch_distributed_tpu_torch.utils import render


@pytest.mark.parametrize("shape", [(4, 84, 84), (84, 84), (30, 40, 3)])
def test_png_decodes_to_the_reference_pixels(shape):
    obs = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    d = tempfile.mkdtemp(prefix="png_")
    port, ref = (render.FrameDumper(f"{d}/port"),
                 jrender.FrameDumper(f"{d}/ref"))
    paths = [port.add(obs), port.add(obs[..., ::-1].copy())]
    jpaths = [ref.add(obs), ref.add(obs[..., ::-1].copy())]
    for p, jp in zip(paths, jpaths):
        assert os.path.relpath(p, f"{d}/port") == os.path.relpath(
            jp, f"{d}/ref")
        assert np.array_equal(np.asarray(Image.open(p)),
                              np.asarray(Image.open(jp)))
    assert np.array_equal(np.asarray(Image.open(paths[0])),
                          render.frame_image(obs))
    assert render.frame_image(np.zeros(4, np.float32)) is None
    assert port.add(np.zeros(4, np.float32)) is None


def test_tester_renders_through_main():
    from pytorch_distributed_tpu_torch.config import build_options
    from pytorch_distributed_tpu_torch.factory import init_params, probe_env

    root = tempfile.mkdtemp(prefix="render_")
    opt = build_options(12, device="cpu", root_dir=root, refs="r")
    spec = probe_env(opt)
    os.makedirs(opt.model_dir, exist_ok=True)
    ckpt.save_params(ckpt.params_path(opt.model_name),
                     init_params(opt, spec, seed=0))
    out = port_main.main([
        "--config", "12", "--mode", "2", "--device", "cpu", "--render",
        "--model-file", opt.model_name, "--set", "tester_nepisodes=2",
        "--set", "early_stop=5", "--set", f"root_dir={root}",
        "--set", "refs=r"])
    assert out["nepisodes"] == 2.0 and out["avg_steps"] == 5.0
    eps = sorted(glob.glob(f"{root}/logs/r/frames/ep*"))
    assert [os.path.basename(e) for e in eps] == ["ep000", "ep001"]
    # the reset's frame and one a step
    assert len(glob.glob(f"{eps[0]}/step*.png")) == 6
    img = np.asarray(Image.open(f"{eps[0]}/step00000.png"))
    assert img.shape == (84, 84) and img.dtype == np.uint8
