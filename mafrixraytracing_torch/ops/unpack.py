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

`gather_rows(table, idx)` is a row gather (`index_select`) with the same
backward, for the other gathers of a train step whose indices collide: the
light rows of NEE (16 columns) and the vertex gather of `apply_params` (3).
"""
from __future__ import annotations

import torch

from mafrixraytracing_torch.ops import cuda

COLS = 36


def fetch_cols_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: rows `table[idx]` (idx clamped to the table) as a
    (36, B) tensor of columns."""
    idx = idx.clamp(0, table.shape[0] - 1)
    return table.index_select(0, idx).t().contiguous()


def unpack_kernel(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA gather-unpack kernel: (P, 36) f32 table, (B,) int64
    idx -> (36, B) f32."""
    cuda.require(table, "table", torch.float32)
    cuda.require(idx, "idx", torch.int64)
    if table.ndim != 2 or table.shape[1] != COLS:
        raise ValueError(f"table must be (P, {COLS}), got {tuple(table.shape)}")
    B, P = idx.shape[0], table.shape[0]
    out = torch.empty((COLS, B), dtype=torch.float32, device=table.device)
    err = cuda.lib().mfx_unpack(table.data_ptr(), idx.data_ptr(), B, P,
                                out.data_ptr(), cuda.stream_of(table))
    cuda.check(err, "unpack")
    cuda.LAUNCHES["unpack"] += 1
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


def scatter_kernel(ct: torch.Tensor, idx: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Launch the CUDA scatter-add: (K, B) f32 columns of any strides, (B,)
    int64 idx in [0, num_rows) -> (num_rows, K) f32. The stable sort and the
    segment starts are preparation in PyTorch; the sum is the kernel's.
    Indices are clamped to the table, so a stray one cannot write outside it."""
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
    order = torch.sort(idx.clamp(0, num_rows - 1).to(torch.int32), stable=True)
    starts = torch.searchsorted(
        order.values,
        torch.arange(num_rows + 1, dtype=torch.int32, device=ct.device))
    part = torch.empty((-(-B // SCATTER_CHUNK), 2, K), dtype=torch.float32,
                       device=ct.device)
    err = cuda.lib().mfx_scatter(
        ct.data_ptr(), ct.stride(0), ct.stride(1), order.values.data_ptr(),
        order.indices.data_ptr(), starts.data_ptr(), B, num_rows, K,
        out.data_ptr(), part.data_ptr(), cuda.stream_of(ct))
    cuda.check(err, "scatter")
    cuda.LAUNCHES["scatter"] += 1
    return out


def scatter_rows(ct: torch.Tensor, idx: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. No fallback between the two."""
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
