"""Packed attribute fetch: one row per ray, returned as 36 SoA columns.

Port of `mafrixraytracing_tpu/ops/unpack_pallas.py`. `fetch_cols(table, idx)`
gathers row `idx[i]` of the (P, 36) packed attribute table for every ray and
returns the rows as a (36, B) tensor whose k-th row is column k. It is a
`torch.autograd.Function`:

- forward: on a CUDA tensor, the hand-written gather-unpack kernel
  (`csrc/unpack.cu`, replacing the Pallas `_unpack_kernel`); on a CPU
  tensor, its plain version `fetch_cols_reference`;
- backward: `index_add_` of the (B, 36) cotangents into a (P, 36) zero
  table, as the JAX package's `_fetch_bwd` (`unpack_pallas.py:89-97`), which
  is XLA there, not a kernel.
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


class _Fetch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return gather_unpack(table.detach(), idx)

    @staticmethod
    def backward(ctx, grad_cols):
        (idx,) = ctx.saved_tensors
        ct = torch.zeros((ctx.num_rows, COLS), dtype=grad_cols.dtype,
                         device=grad_cols.device)
        ct.index_add_(0, idx, grad_cols.t())
        return ct, None


def fetch_cols(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows `table[idx]` as a (36, B) tensor of columns, differentiable with
    respect to `table`. `idx` must lie in [0, P)."""
    if table.shape[1] != COLS:
        raise ValueError(f"table must have {COLS} columns, got {table.shape[1]}")
    return _Fetch.apply(table, idx)
