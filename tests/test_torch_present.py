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


def _halo_rows(x, cfg, n_bands):
    """The bands of chunk-major screen ``x`` and each band's halo pixel rows
    [width * 3], taken from the whole screen's spatial rows (the outermost
    bands get their own edge row)."""
    spatial = cm_to_spatial(torch.from_numpy(x), cfg).numpy()
    rows = cfg.height // n_bands
    bands = np.split(x, n_bands)
    tops = [spatial[max(rows * t - 1, 0)].reshape(-1) for t in range(n_bands)]
    bots = [spatial[min(rows * (t + 1), cfg.height - 1)].reshape(-1) for t in range(n_bands)]
    return bands, tops, bots


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("w,h,n_bands", [(64, 48, 2), (64, 48, 3), (1920, 1080, 2)])
def test_halo_present_bands_are_the_whole_screen(w, h, n_bands, quantize):
    """The halo variant band by band, with the neighbours' rows, put together
    is bitwise the single screen's present."""
    _, cfg, x = _screen(w, h, seed=1)
    band_cfg = PScreen(width=w, height=h // n_bands)
    whole = present_plain(torch.from_numpy(x), cfg, quantize)
    bands, tops, bots = _halo_rows(x, cfg, n_bands)
    got = torch.cat([present(torch.from_numpy(b), band_cfg, quantize, torch.from_numpy(t),
                             torch.from_numpy(u))
                     for b, t, u in zip(bands, tops, bots)])
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(whole.numpy()))


@pytest.mark.parametrize("quantize", [True, False])
def test_halo_present_matches_jax_bitwise(quantize):
    """``present_plain`` with halo rows against the JAX package's Pallas
    present kernel with ``halo_top`` / ``halo_bot`` (interpreted, under jit),
    which takes each row embedded at a chunk row's lane offsets; the rows are
    random, not a neighbour's, so that a halo read in the wrong place
    shows."""
    from mirror_maze_tpu.render.present import present_pallas

    w, h, cw = 64, 24, 4
    _, cfg, x = _screen(w, h, seed=2)
    rng = np.random.default_rng(3)
    top, bot = (rng.random(w * 3).astype(np.float32) for _ in range(2))
    cx, cy = w // cw, h // cw
    zpad = np.zeros((1, cx, cw, cw - 1, 3), np.float32)
    ht = np.concatenate([zpad, top.reshape(1, cx, cw, 1, 3)], axis=3).reshape(1, -1)
    hb = np.concatenate([bot.reshape(1, cx, cw, 1, 3), zpad], axis=3).reshape(1, -1)
    want = jax.jit(lambda s, a, b: present_pallas(
        s, chunks_x=cx, chunks_y=cy, cw=cw, quantize=quantize, halo_top=a, halo_bot=b))(
            jnp.asarray(x), jnp.asarray(ht), jnp.asarray(hb))
    got = present_plain(torch.from_numpy(x), cfg, quantize, torch.from_numpy(top),
                        torch.from_numpy(bot))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert not np.array_equal(got.numpy(), present_plain(torch.from_numpy(x), cfg, quantize))


def test_present_rejects_bad_halos():
    _, cfg, x = _screen(64, 48)
    row = torch.zeros(64 * 3)
    with pytest.raises(ValueError, match="both"):
        present(torch.from_numpy(x), cfg, True, halo_top=row)
    with pytest.raises(ValueError, match="halo_bot"):
        present(torch.from_numpy(x), cfg, True, halo_top=row, halo_bot=row[:-3])
    with pytest.raises(ValueError, match="halo_top"):
        present_plain(torch.from_numpy(x), cfg, True, halo_top=row.double(), halo_bot=row)
