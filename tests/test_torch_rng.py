"""The port's threefry RNG is bit-equal to jax.random (JAX package reference).

Keys and uniforms from `mafrixraytracing_torch.core.rng` must equal those of
`mafrixraytracing_tpu.core.rng` exactly: a render at the same seed then
traces the same paths in both packages.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng as trng
from mafrixraytracing_torch.utils import trace
from mafrixraytracing_tpu.core import rng as jrng
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

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


# --- the route to the threefry kernels (csrc/rng.cu), without a card ---

class CardKey(torch.Tensor):
    """A CPU tensor that reads as a CUDA one: the routing sees a card's key."""

    @property
    def is_cuda(self):
        return True


def _plain(t):
    return t.as_subclass(torch.Tensor) if isinstance(t, torch.Tensor) else t


def _kernel_model(calls):
    """A stand-in for `cuda.launch` that records and counts each launch, as
    `cuda.launch` counts it in `LAUNCHES`, and computes what the kernels
    compute, by their own index arithmetic: fold output k * D + d folds key
    row k * key_step with datum k * data_k + d * data_d (or start plus that
    index without data); uniform row b holds n draws."""
    def launch(name, *args):
        calls.append((name, args))
        trng.cuda.LAUNCHES[name] += 1
        if name == "rng_fold":
            rows, key_step, vals, data_k, data_d, start, K, D, out = map(_plain, args)
            i = torch.arange(K * D)
            k, d = i // D, i % D
            j = k * data_k + d * data_d
            x = vals[j] if vals is not None else start + j
            out.view(-1, 2)[:] = trng._fold_in(rows[k * key_step], x)
        else:
            rows, dim, n, B, out = map(_plain, args)
            out.view(B, n)[:] = trng._uniforms(rows, dim, (n,))
    return launch


def _rng_launches():
    return trng.cuda.LAUNCHES["rng_fold"] + trng.cuda.LAUNCHES["rng_uniform"]


def _keys(n, seed=3):
    return trng.pixel_keys(trng.root_key(seed, "cpu"), n)


BIG = torch.tensor([0, 1, -1, -2**31, 2**31, 2**31 + 5, 2**32 - 1, 2**32, 2**40 + 3])

# (label, public function, key, arguments, whether the caller's tensors reach
# the kernel as they are): every broadcast form of the port's callers, then
# forms that take a copy first
ROUTES = [
    ("bounce_key", "bounce_key", lambda: _keys(300), (3,), True),
    ("split_dim", "split_dim", lambda: _keys(300), (41,), True),
    ("sample_key int", "sample_key", lambda: _keys(300), (2**31 + 7,), True),
    ("sample_key outer", "sample_key", lambda: _keys(40)[8:24][:, None, :],
     ((5 + torch.arange(4))[None, :],), True),
    ("fold_in pixel ids", "fold_in", lambda: trng.root_key(7, "cpu"),
     (torch.tensor([0, 5, 9, 2**31 + 1, 123456]),), True),
    ("fold_in rank", "fold_in", lambda: trng.root_key(7, "cpu"), (-3,), True),
    ("fold_in paired", "fold_in", lambda: _keys(9), (BIG,), True),
    ("pixel_keys", "pixel_keys", lambda: trng.root_key(2**31 + 5, "cpu"), (777,), True),
    ("split", "split", lambda: trng.root_key(11, "cpu"), (2,), True),
    ("uniforms", "uniforms", lambda: _keys(257), (99,), True),
    ("uniforms 2", "uniforms", lambda: _keys(257), (1000, (2,)), True),
    ("uniforms 3", "uniforms", lambda: _keys(257), (1, (3,)), True),
    ("uniforms 2x3", "uniforms", lambda: _keys(5), (2**32 + 40, (2, 3)), True),
    ("fold_in int32 data", "fold_in", lambda: _keys(9), (BIG.to(torch.int32),), False),
    ("strided keys", "bounce_key", lambda: _keys(300)[::3], (4,), False),
    ("keys over data, tiled", "fold_in", lambda: _keys(6).reshape(2, 3, 2),
     (torch.tensor([4, 5, 6]),), False),
    ("data over keys", "fold_in", lambda: _keys(4)[None], (torch.arange(3)[:, None],), False),
]


@pytest.mark.parametrize("label,fn,make_key,args,as_is", ROUTES, ids=[r[0] for r in ROUTES])
def test_card_key_takes_one_kernel_launch(label, fn, make_key, args, as_is, monkeypatch):
    """A key whose device is a card takes one launch of the kernel, with the
    caller's tensors as they are for every form the port uses, and gets the
    plain version's bits."""
    key = make_key()
    want = getattr(trng, fn)(key, *args)
    calls = []
    monkeypatch.setattr(trng.cuda, "launch", _kernel_model(calls))
    trace.reset_counters()
    trng.cuda.reset_launches()
    got = getattr(trng, fn)(key.as_subclass(CardKey), *args)
    assert [c[0] for c in calls] == ["rng_uniform" if fn == "uniforms" else "rng_fold"]
    assert trace.COUNTERS["rng_calls"] == 1 == _rng_launches()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_plain(got), want)
    rows, data = calls[0][1][0], calls[0][1][2]
    if as_is:
        assert rows.data_ptr() == key.data_ptr()
        if isinstance(args[0], torch.Tensor):
            assert data.data_ptr() == args[0].data_ptr()


def test_cpu_key_takes_the_plain_version_and_counts(monkeypatch):
    """On the CPU every public draw counts one call and none takes the
    kernels; the route follows the key's device, not the data's."""
    calls = []
    monkeypatch.setattr(trng.cuda, "launch", _kernel_model(calls))
    trace.reset_counters()
    trng.cuda.reset_launches()
    key = trng.root_key(5, "cpu")
    keys = trng.pixel_keys(key, 64)
    trng.split(key)
    trng.fold_in(key, torch.arange(3).as_subclass(CardKey))
    trng.sample_key(keys[:, None, :], torch.arange(2)[None, :])
    trng.uniforms(trng.split_dim(trng.bounce_key(keys, 1), 40), 0, (2,))
    assert calls == []
    assert trace.COUNTERS["rng_calls"] == 7 and _rng_launches() == 0
    trng.bounce_key(keys.as_subclass(CardKey), 2)
    assert len(calls) == 1
    assert trace.COUNTERS["rng_calls"] == 8 and _rng_launches() == 1


@pytest.mark.parametrize("kshape,dshape,want", [
    ((300,), (), ((300,), (300, 1, 1, 0, 0))),
    ((), (777,), ((777,), (1, 777, 0, 0, 1))),
    ((16, 1), (1, 4), ((16, 4), (16, 4, 1, 0, 1))),
    ((9,), (9,), ((9,), (9, 1, 1, 1, 0))),
    ((), (), ((), (1, 1, 1, 1, 0))),
    ((2, 3), (3,), ((2, 3), None)),
    ((1, 4), (3, 1), ((3, 4), None)),
])
def test_fold_grid_layouts(kshape, dshape, want):
    assert trng._grid(kshape, dshape) == want


def test_fold_grid_imports_nothing():
    """The grid's broadcast is worked out in Python: `torch.broadcast_shapes`
    imports sympy at its first call, seconds of a card run's set-up."""
    code = ("import sys; from mafrixraytracing_torch.core import rng; "
            "rng._grid((5, 1), (1, 3)); "
            "print('torch.fx.experimental.symbolic_shapes' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "False"
