"""Packed attribute fetch: one row per ray, returned as 36 SoA columns.

Port of `mafrixraytracing_tpu/ops/unpack_pallas.py`. `fetch_cols(table, idx)`
gathers row `idx[i]` of the (P, 36) packed attribute table for every ray and
returns the rows as a (36, B) tensor whose k-th row is column k. It is a
`torch.autograd.Function`:

- forward: on a CUDA tensor, the hand-written gather-unpack kernel
  (`csrc/unpack.cu`, replacing the Pallas `_unpack_kernel`); on a CPU
  tensor, its plain version `fetch_cols_reference`;
- backward: `scatter_rows`, the scatter-add of the (36, B) cotangent columns
  into a (P, 36) zero table (the JAX package's `_fetch_bwd`,
  `unpack_pallas.py:89-97`). On a CUDA tensor that is the hand-written
  deterministic kernel of `csrc/scatter.cu` (replacing the Pallas
  `_scatter_kernel` of `experiments/exp_scatter.py`): a stable sort of the
  indices, then a segmented sum in an order the inputs alone fix, with no
  float atomics, so the same inputs give the same bits run after run and a
  fit resumed from a checkpoint repeats the uninterrupted one. On a CPU
  tensor it is the plain version `scatter_rows_reference` (`index_add_`).
  `scatter_rows_ordered_reference` is the kernel's own sum order in
  PyTorch, bit-equal to it, for the tests and `chip_smoke.py`.

`gather_rows(table, idx)` is a row gather (`index_select`) with the same
backward, for the other gathers of a train step whose indices collide: the
light rows of NEE (16 columns) and the vertex gather of `apply_params` (3).
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.ops import cuda
from mafrixraytracing_torch.utils import trace

COLS = 36


def fetch_cols_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: rows `table[idx]` (idx clamped to the table) as a
    (36, B) tensor of columns."""
    idx = idx.clamp(0, table.shape[0] - 1)
    return table.index_select(0, idx).t().contiguous()


def unpack_kernel(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather-unpack kernel: (P, 36) f32 table, (B,) int64
    idx -> (36, B) f32, bit-equal to `fetch_cols_reference`. The table's base
    must be 16-byte aligned (the kernel reads rows in 16-byte pieces)."""
    cuda.require(table, "table", torch.float32)
    cuda.require(idx, "idx", torch.int64)
    if table.ndim != 2 or table.shape[1] != COLS:
        raise ValueError(f"table must be (P, {COLS}), got {tuple(table.shape)}")
    B, P = idx.shape[0], table.shape[0]
    if P == 0 and B > 0:
        raise ValueError("table has no rows to gather from")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    out = torch.empty((COLS, B), dtype=torch.float32, device=table.device)
    cuda.launch("unpack", table, idx, B, P, out)
    return out


def gather_unpack(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. No fallback between the two."""
    if table.is_cuda:
        return unpack_kernel(table.contiguous(), idx.to(torch.int64).contiguous())
    return fetch_cols_reference(table, idx)


SCATTER_COLS = (1, 3, 16, 36)   # the column counts csrc/scatter.cu is built for
SCATTER_CHUNK = 256             # sorted positions per block there


def scatter_rows_reference(ct: torch.Tensor, idx: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """Plain version: `out[p, k] = sum of ct[k, i] over i with idx[i] == p`
    for (K, B) cotangent columns -> (num_rows, K)."""
    out = torch.zeros((num_rows, ct.shape[0]), dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, idx, ct.t())


def scatter_rows_ordered_reference(ct: torch.Tensor, idx: torch.Tensor,
                                   num_rows: int) -> torch.Tensor:
    """Plain version of kernel J's own sum order, bit-equal to it: the stable
    sort, chunks of `SCATTER_CHUNK` sorted positions, in each chunk the 8
    doubling steps of a segmented inclusive scan that never cross a
    segment's start, the partials of segments cut by a chunk's edge (slot 0:
    begun in an earlier chunk; slot 1: begun here and going on), and for a
    row that spans chunks c0..c1, lane l summing the partials of chunks
    c0 + l + 32 m in ascending m from 0.0, then the shuffle tree 16, 8, 4, 2,
    1. Vectorised over chunks ((chunks, 256, K) tensors, masked adds). For
    the tests and `chip_smoke.py`, never the main path."""
    K, B = ct.shape
    dev = ct.device
    out = torch.zeros((num_rows, K), dtype=torch.float32, device=dev)
    if B == 0 or num_rows == 0:
        return out
    C = SCATTER_CHUNK
    values, perm, starts = scatter_order(idx, num_rows)
    sidx = values.long()
    n = -(-B // C)
    pos = torch.arange(B, device=dev)
    base = pos - pos % C
    seg_start, seg_end = starts[sidx], starts[sidx + 1]
    # pass 1: a dead position (past B) holds 0 and never adds
    acc = torch.zeros((n * C, K), dtype=torch.float32, device=dev)
    acc[:B] = ct.t()[perm]
    acc = acc.view(n, C, K)
    run_start = torch.full((n * C,), C, dtype=torch.int64, device=dev)
    run_start[:B] = (seg_start - base).clamp(min=0)
    run_start = run_start.view(n, C)
    j = torch.arange(C, device=dev)
    d = 1
    while d < C:
        shifted = torch.cat([torch.zeros_like(acc[:, :d]), acc[:, :-d]], dim=1)
        acc = torch.where((j - d >= run_start)[..., None], acc + shifted, acc)
        d *= 2
    acc = acc.view(n * C, K)[:B]
    chunk_end = (base + C).clamp(max=B)
    last = (pos + 1 == seg_end) | (pos + 1 == chunk_end)
    head, cut = seg_start < base, seg_end > chunk_end
    whole = last & ~head & ~cut
    out[sidx[whole]] = acc[whole]
    # pass 2: the rows whose segment spans chunks
    first = last & ~head & cut                 # slot 1: a spanning row's first chunk
    rest = last & head                         # slot 0: its later chunks
    if not bool(first.any()):
        return out
    chunk = pos // C
    part = torch.zeros((n, 2, K), dtype=torch.float32, device=dev)
    part[chunk[rest], 0] = acc[rest]
    part[chunk[first], 1] = acc[first]
    rows, c0 = sidx[first], chunk[first]
    c1 = (seg_end[first] - 1) // C
    lanes = torch.zeros((rows.numel(), 32, K), dtype=torch.float32, device=dev)
    for m in range(-(-int((c1 - c0 + 1).max()) // 32)):
        c = c0[:, None] + 32 * m + torch.arange(32, device=dev)
        v = part[c.clamp(max=n - 1), (c == c0[:, None]).long()]
        lanes = torch.where((c <= c1[:, None])[..., None], lanes + v, lanes)
    off = 16
    while off:
        lanes[:, :off] = lanes[:, :off] + lanes[:, off:2 * off]
        off //= 2
    out[rows] = lanes[:, 0]
    return out


def scatter_order(idx: torch.Tensor, num_rows: int):
    """Kernel J's preparation: (sorted indices (int32), the permutation,
    starts (num_rows + 1,)): the stable sort of the indices clamped to the
    table, and each row's first sorted position."""
    order = torch.sort(idx.clamp(0, num_rows - 1).to(torch.int32), stable=True)
    starts = torch.searchsorted(
        order.values,
        torch.arange(num_rows + 1, dtype=torch.int32, device=idx.device))
    return order.values, order.indices, starts


def scatter_scratch(ct: torch.Tensor):
    """Kernel J's scratch for (K, B) columns: the partials (2, K, chunks)
    and each chunk's spanning row (chunks,)."""
    K, B = ct.shape
    chunks = -(-B // SCATTER_CHUNK)
    return (torch.empty((2, K, chunks), dtype=torch.float32, device=ct.device),
            torch.empty((chunks,), dtype=torch.int32, device=ct.device))


def scatter_passes(ct, values, perm, starts, num_rows, out, part, span,
                   passes: int = 3) -> None:
    """Launch kernel J's pass 1 (`passes` & 1) and pass 2 (& 2) on prepared
    operands (`scatter_order`, `scatter_scratch`); pass 2 reads what pass 1
    wrote."""
    K, B = ct.shape
    cuda.launch("scatter", ct, ct.stride(0), ct.stride(1), values, perm,
                starts, B, num_rows, K, out, part, span, passes)


def scatter_kernel(ct: torch.Tensor, idx: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Launch the CUDA scatter-add: (K, B) f32 columns of any strides, (B,)
    int64 idx in [0, num_rows) -> (num_rows, K) f32, bit-equal to
    `scatter_rows_ordered_reference`. The stable sort and the segment starts
    are preparation in PyTorch; the sum is the kernel's.
    Indices are clamped to the table, so a stray one cannot write outside it.

    Its launches, with their device time on an H100 80GB HBM3 at 700 W for
    the mesh's primary hits (B = 524,288, num_rows = 65,544, K = 36; the
    profiler's kernel records, `chip_smoke.py --walks`): `zeros` for the
    output, the clamp and the int32 cast of the indices and the sort's own
    index fill (together 0.022 ms); the stable sort (CUB's radix sort, 0.043
    ms); `arange` and `searchsorted` for the starts (0.006 ms); pass 1
    (0.057 ms) and pass 2 (0.010 ms) in one call of `mfx_scatter`. The two
    `empty` of `scatter_scratch` launch nothing. From Python the ten
    launches take longer than the device does, so J's stream time there is
    the host's (0.19-0.46 ms by CUDA events against 0.14 ms of kernels)."""
    if not ct.is_cuda or ct.dtype != torch.float32 or ct.ndim != 2:
        raise ValueError("ct must be a 2-D float32 CUDA tensor")
    cuda.require(idx, "idx", torch.int64, (ct.shape[1],))
    K, B = ct.shape
    if K not in SCATTER_COLS:
        raise ValueError(f"the scatter kernel is built for {SCATTER_COLS} "
                         f"columns, got {K}")
    out = torch.zeros((num_rows, K), dtype=torch.float32, device=ct.device)
    if B == 0 or num_rows == 0:
        return out
    scatter_passes(ct, *scatter_order(idx, num_rows), num_rows, out,
                   *scatter_scratch(ct))
    return out


def scatter_rows(ct: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. No fallback between the two. Counts the rows summed in
    `utils.trace`'s `scatter_rows`."""
    trace.count("scatter_rows", idx.shape[0])
    if ct.is_cuda:
        return scatter_kernel(ct, idx.to(torch.int64).contiguous(), num_rows)
    return scatter_rows_reference(ct, idx, num_rows)


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return gather_unpack(table.detach(), idx)

    @staticmethod
    def backward(ctx, grad_cols):
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad_cols, idx, ctx.num_rows), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad_rows):
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad_rows.t(), idx, ctx.num_rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `table[idx]` as (B, K), differentiable with respect to `table`
    through `scatter_rows`; K must be one of `SCATTER_COLS` on the card.
    `idx` (int64) must lie in [0, P)."""
    return _GatherRows.apply(table, idx)


def fetch_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `table[idx]` as a (36, B) tensor of columns, differentiable with
    respect to `table`. `idx` must lie in [0, P)."""
    if table.shape[1] != COLS:
        raise ValueError(f"table must have {COLS} columns, got {table.shape[1]}")
    return _Fetch.apply(table, idx)
