"""The present kernel's plain version against the JAX package's blur +
quantize, bitwise (the CUDA kernel against its plain version is in
tests/test_torch_cuda.py).

The reference is the JAX functions as the engine runs them: under jit,
where XLA compiles the blur's /3 and the quantizer's /255 into multiplies
by float32 reciprocals (the same on the CPU as on the TPU). The Pallas
present kernel, interpreted inside the jitted step, computes the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mirror_maze_tpu.config import ScreenConfig
from mirror_maze_tpu.render.accumulate import feedback_blur_cm, quantize_8bit
from mirror_maze_tpu.render.present import present as j_present
from mirror_maze_tpu_torch.config import ScreenConfig as PScreen
from mirror_maze_tpu_torch.render.accumulate import cm_to_spatial, to_display
from mirror_maze_tpu_torch.render.present import present, present_plain

SIZES = [(64, 48), (1920, 1080)]


def _screen(w, h, seed=0):
    cfg = ScreenConfig(width=w, height=h)
    x = np.random.default_rng(seed).random(
        (cfg.total_chunks, cfg.pixels_per_chunk * 3)).astype(np.float32)
    return cfg, PScreen(width=w, height=h), x * 1.2 - 0.1


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("w,h", SIZES)
def test_plain_present_matches_jax_bitwise(w, h, quantize):
    jcfg, cfg, x = _screen(w, h)

    @jax.jit
    def ref(s):
        out = feedback_blur_cm(s, jcfg)
        return quantize_8bit(out) if quantize else out

    want = ref(jnp.asarray(x))
    got = present_plain(torch.from_numpy(x), cfg, quantize)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # The cpu wrapper is the plain version.
    np.testing.assert_array_equal(_bits(present(torch.from_numpy(x), cfg, quantize)), _bits(want))
    if w == 64:
        # ... and so is the JAX package's own present stage (the Pallas
        # kernel, interpreted) under jit.
        pallas = jax.jit(lambda s: j_present(s, jcfg, quantize=quantize))(jnp.asarray(x))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(pallas))


def test_display_layout_matches_jax():
    from mirror_maze_tpu.render.accumulate import cm_to_spatial as j_sp
    from mirror_maze_tpu.render.accumulate import to_display as j_disp

    jcfg, cfg, x = _screen(64, 48)
    np.testing.assert_array_equal(
        to_display(cm_to_spatial(torch.from_numpy(x), cfg)).numpy(),
        np.asarray(j_disp(j_sp(jnp.asarray(x), jcfg))))


def test_present_rejects_bad_screens():
    _, cfg, x = _screen(64, 48)
    with pytest.raises(ValueError):
        present(torch.from_numpy(x[:-1]), cfg, True)
    with pytest.raises(ValueError):
        present(torch.from_numpy(x).double(), cfg, True)
