"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from _torch_tools import assert_frames_match, golden_config, golden_script
from mirror_maze_tpu_torch import kernels
from mirror_maze_tpu_torch.config import ScreenConfig, TracerConfig, config_interactive
from mirror_maze_tpu_torch.render.fused_tracer import trace_paths_fused, trace_paths_plain
from mirror_maze_tpu_torch.render.present import present, present_plain
from mirror_maze_tpu_torch.render.scenebuf import upload_scene
from mirror_maze_tpu_torch.runtime.loop import run_scripted
from mirror_maze_tpu_torch.runtime.state import FrameInputs
from mirror_maze_tpu_torch.scene import build_scene

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "script_pallas.npz")


@pytest.fixture
def cuda_device():
    """The CUDA card; skips the test on a machine without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("quantize", [True, False])
def test_present_kernel_matches_plain_bitwise(cuda_device, quantize):
    cfg = ScreenConfig(width=1920, height=1080)
    x = np.random.default_rng(0).random(
        (cfg.total_chunks, cfg.pixels_per_chunk * 3)).astype(np.float32) * 1.2 - 0.1
    s = torch.from_numpy(x).to(cuda_device)
    before = kernels.launches["present"]
    got = present(s, cfg, quantize)
    assert kernels.launches["present"] == before + 1
    want = present_plain(s, cfg, quantize)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bounce,mirror", [(1, 2), (5, 8)])
def test_tracer_kernel_matches_plain(cuda_device, bounce, mirror):
    scene = upload_scene(build_scene(config_interactive().maze), device=cuda_device)
    rng = np.random.default_rng(bounce)
    n = 100_001
    o = rng.uniform(-45, 45, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-7, 1, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (scene.planes, scene.mode_counts,
            torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(cuda_device),
            torch.tensor([7], dtype=torch.int32, device=cuda_device),
            TracerConfig(bounce_limit=bounce, mirror_limit=mirror), 96)
    before = kernels.launches["tracer"]
    got = trace_paths_fused(*args)
    assert kernels.launches["tracer"] == before + 1
    want = trace_paths_plain(*args)
    close = torch.isclose(got, want, rtol=1e-5, atol=1e-6).all(dim=1)
    assert float(close.float().mean()) >= 0.999
    assert float(want.mean()) > 0


def test_scripted_run_on_the_card_matches_golden(cuda_device):
    cfg = golden_config()
    script = golden_script(FrameInputs)
    kernels.reset_launches()
    _, frame = run_scripted(upload_scene(build_scene(cfg.maze), device=cuda_device), cfg,
                            inputs=script)
    assert kernels.launches["tracer"] == kernels.launches["present"] == len(script)
    with np.load(GOLDEN) as z:
        assert_frames_match(frame, z["img"])
