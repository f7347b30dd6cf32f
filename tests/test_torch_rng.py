"""The port's threefry RNG is bit-equal to jax.random (JAX package reference).

Keys and uniforms from `mafrixraytracing_torch.core.rng` must equal those of
`mafrixraytracing_tpu.core.rng` exactly: a render at the same seed then
traces the same paths in both packages.
"""
import jax
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_tpu.core import rng as jrng

SEEDS = [0, 1, 123, 2**31 + 5]


def _kd(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_root_and_pixel_keys(seed):
    np.testing.assert_array_equal(_kd(jax.random.key(seed)),
                                  trng.root_key(seed, "cpu").numpy())
    jk = jrng.pixel_keys(jax.random.key(seed), 257)
    tk = trng.pixel_keys(trng.root_key(seed, "cpu"), 257)
    np.testing.assert_array_equal(_kd(jk), tk.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_and_bounce_keys(seed):
    jk = jrng.pixel_keys(jax.random.key(seed), 64)
    tk = trng.pixel_keys(trng.root_key(seed, "cpu"), 64)
    for s in (0, 3, 63, 1000):
        np.testing.assert_array_equal(_kd(jrng.sample_key(jk, s)),
                                      trng.sample_key(tk, s).numpy())
    for b in range(5):
        np.testing.assert_array_equal(_kd(jrng.bounce_key(jk, b)),
                                      trng.bounce_key(tk, b).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (2,), (3,)])
def test_uniforms_bit_equal(seed, shape):
    jk = jrng.bounce_key(jrng.pixel_keys(jax.random.key(seed), 300), 2)
    tk = trng.bounce_key(trng.pixel_keys(trng.root_key(seed, "cpu"), 300), 2)
    for dim in (0, 10, 97, 1000):
        ju = np.asarray(jrng.uniforms(jk, dim, shape))
        tu = trng.uniforms(tk, dim, shape).numpy()
        assert tu.dtype == np.float32 and tu.shape == ju.shape
        np.testing.assert_array_equal(ju.view(np.uint32), tu.view(np.uint32))


def test_batched_sample_keys_match_render_layout():
    """render_image folds G sample indices per pixel key, pixel-major."""
    jk = jrng.pixel_keys(jax.random.key(9), 16)
    sidx = jax.numpy.arange(4) + 8
    jsk = jax.vmap(lambda s: jrng.sample_key(jk, s))(sidx)
    jsk = jax.numpy.swapaxes(jsk, 0, 1).reshape(64)
    tk = trng.pixel_keys(trng.root_key(9, "cpu"), 16)
    tsk = trng.sample_key(tk[:, None, :], (torch.arange(4) + 8)[None, :])
    np.testing.assert_array_equal(_kd(jsk), tsk.reshape(64, 2).numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bit_equal_chained(seed):
    """`fit` walks its key chain with split: bit-equal to `jax.random.split`
    under the installed JAX's defaults, five deep."""
    jk, tk = jax.random.key(seed), trng.root_key(seed, "cpu")
    for _ in range(5):
        jk, jsub = jax.random.split(jk)
        tk, tsub = trng.split(tk)
        np.testing.assert_array_equal(_kd(jk), tk.numpy())
        np.testing.assert_array_equal(_kd(jsub), tsub.numpy())


@pytest.mark.parametrize("num", [1, 2, 5])
def test_split_num(num):
    jk = jax.random.split(jax.random.key(77), num)
    tk = trng.split(trng.root_key(77, "cpu"), num)
    assert tk.shape == (num, 2) and tk.dtype == torch.int64
    np.testing.assert_array_equal(_kd(jk), tk.numpy())
