"""The scatter-add backward of the port's gathers, on the CPU.

`ops.unpack.scatter_rows` is the backward of `fetch_cols` (36 columns) and of
`gather_rows` (the light rows, 16; the vertex gather, 3). On the CPU it runs
its plain version, `index_add_`. Held against:
- numpy's `np.add.at` (the definition);
- `jax.grad` through the JAX package's `unpack_pallas.fetch_cols` and through
  `table[idx]`, rtol 1e-5 / atol 1e-6 (the sums run in another order);
- a numpy model of the CUDA kernel's two passes (`csrc/scatter.cu`: a
  segmented scan over chunks of 256 sorted positions, partial sums of cut
  segments combined per table row), which checks the kernel's bookkeeping
  of segments, chunks and slots where no card is at hand. The kernel itself
  is held against the plain version on the card (`test_torch_kernels.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.ops import unpack as ou
from mafrixraytracing_tpu.ops import unpack_pallas as jun

CHUNK = ou.SCATTER_CHUNK


def kernel_model(ct, idx, P):
    """`csrc/scatter.cu` in numpy float32: the wrapper's preparation, pass 1
    (one "block" per chunk) and pass 2 (one "warp" per table row)."""
    K, B = ct.shape
    order = np.argsort(idx, kind="stable")
    sidx = idx[order]
    starts = np.searchsorted(sidx, np.arange(P + 1), side="left")
    out = np.zeros((P, K), np.float32)
    nchunks = -(-B // CHUNK)
    part = np.full((nchunks, 2, K), np.nan, np.float32)   # unwritten = poison
    for c in range(nchunks):
        base = c * CHUNK
        end = min(base + CHUNK, B)
        n = end - base
        acc = ct[:, order[base:end]].T.copy()             # (n, K)
        run_start = np.maximum(starts[sidx[base:end]] - base, 0)
        d = 1
        while d < CHUNK:
            prev = acc.copy()
            j = np.arange(n)
            take = j - d >= run_start
            acc[take] = prev[take] + prev[j[take] - d]
            d *= 2
        for j in range(n):
            pos = base + j
            p = sidx[pos]
            seg_end = starts[p + 1]
            if pos + 1 != seg_end and pos + 1 != end:
                continue
            head, cut = starts[p] < base, seg_end > end
            if not head and not cut:
                out[p] = acc[j]
            else:
                part[c, 0 if head else 1] = acc[j]
    for p in range(P):
        s, e = starts[p], starts[p + 1]
        if e <= s:
            continue
        c0, c1 = s // CHUNK, (e - 1) // CHUNK
        if c0 == c1:
            continue
        lanes = np.zeros((32, K), np.float32)
        for c in range(c0, c1 + 1):
            lanes[(c - c0) % 32] += part[c, 1 if c == c0 else 0]
        off = 16
        while off:
            lanes[:off] = lanes[:off] + lanes[off:2 * off]
            off //= 2
        out[p] = lanes[0]
    return out


def case(name, K, seed=0):
    rs = np.random.default_rng(seed)
    B, P = {"few_rows": (5000, 7), "many_rows": (3001, 4000),
            "one_row": (2000, 9), "tiny": (5, 3), "exact_chunks": (1024, 4),
            "runs": (4096, 500)}[name]
    if name == "one_row":
        idx = np.full(B, 4)
    elif name == "exact_chunks":     # segments that end on chunk edges
        idx = np.repeat(np.arange(4), 256)
    elif name == "runs":
        idx = np.repeat(np.arange(P), rs.integers(1, 40, P))[:B]
        idx = np.concatenate([idx, rs.integers(0, P, B - idx.size)])
    else:
        idx = rs.integers(0, P, B)
    ct = rs.normal(size=(K, B)).astype(np.float32)
    ct[:, rs.random(B) < 0.1] = 0.0
    return ct, idx.astype(np.int64), P


NAMES = ["few_rows", "many_rows", "one_row", "tiny", "exact_chunks", "runs"]


@pytest.mark.parametrize("K", [1, 3, 16, 36])
@pytest.mark.parametrize("name", NAMES)
def test_scatter_rows_matches_definition_and_kernel_model(name, K):
    ct, idx, P = case(name, K)
    want = np.zeros((P, K), np.float64)
    np.add.at(want, idx, ct.T.astype(np.float64))
    mass = np.zeros((P, K), np.float64)
    np.add.at(mass, idx, np.abs(ct.T).astype(np.float64))
    got = ou.scatter_rows(torch.as_tensor(ct), torch.as_tensor(idx), P).numpy()
    tol = 1e-5 * mass + 1e-6
    assert (np.abs(got - want) <= tol).all()
    model = kernel_model(ct, idx, P)
    assert np.isfinite(model).all()      # no unwritten partial was read
    assert (np.abs(model - want) <= tol).all()
    # rows as a strided view: the same function
    rows = torch.as_tensor(np.ascontiguousarray(ct.T))
    assert torch.equal(ou.scatter_rows(rows.t(), torch.as_tensor(idx), P),
                       torch.as_tensor(got))


def test_fetch_cols_gradient_matches_jax():
    rs = np.random.default_rng(3)
    P, B = 50, 4096
    table = rs.normal(size=(P, 36)).astype(np.float32)
    idx = rs.integers(0, 12, B)          # heavy repeats
    idx[::7] = rs.integers(0, P, idx[::7].size)
    w = rs.normal(size=(36, B)).astype(np.float32)

    def jloss(t):
        cols = jun.fetch_cols(t, jnp.asarray(idx))
        return sum(jnp.sum(c * w[k]) for k, c in enumerate(cols))

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.as_tensor(table).requires_grad_()
    cols = ou.fetch_cols(t, torch.as_tensor(idx))
    np.testing.assert_array_equal(cols.detach().numpy(), table[idx].T)
    (cols * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K,P", [(16, 8), (3, 200)])
def test_gather_rows_gradient_matches_jax(K, P):
    rs = np.random.default_rng(K)
    B = 3000
    table = rs.normal(size=(P, K)).astype(np.float32)
    idx = rs.integers(0, P, B)
    w = rs.normal(size=(B, K)).astype(np.float32)
    jg = np.asarray(jax.grad(lambda t: jnp.sum(t[jnp.asarray(idx)] * w))(
        jnp.asarray(table)))
    t = torch.as_tensor(table).requires_grad_()
    rows = ou.gather_rows(t, torch.as_tensor(idx))
    np.testing.assert_array_equal(rows.detach().numpy(), table[idx])
    (rows * torch.as_tensor(w)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5, atol=1e-5)


def test_scatter_kernel_checks_its_operands():
    with pytest.raises(ValueError, match="CUDA"):
        ou.scatter_kernel(torch.zeros(36, 4), torch.zeros(4, dtype=torch.long), 8)
    assert set(ou.SCATTER_COLS) == {1, 3, 16, 36}
