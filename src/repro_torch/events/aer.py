"""Packed per-step AER event tables (the device-resident staging format).

One fixed-capacity, valid-first event list per time step, so slicing the
step axis yields a chunk's worth of ready-to-gather events.  Addresses are
int16 when the address space fits, values int8 signed spike magnitudes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepEventTable(NamedTuple):
    """Packed per-step AER event lists of a dense spike train.

    addrs:  (..., T, C) int16/int32 event addresses, packed valid-first
    values: (..., T, C) int8 signed spike magnitudes (0 on padding)
    counts: (..., T) int32 valid events per step
    """

    addrs: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.addrs.shape[-1]

    @property
    def num_steps(self) -> int:
        return self.addrs.shape[-2]


def addr_dtype_for(num_addrs: int) -> torch.dtype:
    """Narrowest integer dtype that can index ``num_addrs`` addresses."""
    return (
        torch.int16
        if num_addrs <= torch.iinfo(torch.int16).max
        else torch.int32
    )


def check_addr_dtype(num_addrs: int, addr_dtype: torch.dtype) -> None:
    """Raise if ``addr_dtype`` cannot index ``num_addrs`` addresses: a
    narrowing cast of an out-of-range address wraps silently."""
    info = torch.iinfo(addr_dtype)
    if num_addrs - 1 > int(info.max):
        raise ValueError(
            f"address dtype {addr_dtype} cannot index {num_addrs} "
            f"addresses (max {int(info.max) + 1}): int16 AER tables "
            "silently wrap — use addr_dtype_for(num_addrs) or int32"
        )


def step_table_to_dense(table: StepEventTable, num_addrs: int) -> torch.Tensor:
    """Scatter a per-step event table back to a dense (..., T, N) train.

    Inverse of ``runtime.encode_step_table`` whenever the capacity covered
    each step's events at encode time.
    """
    C = table.capacity
    valid = (
        torch.arange(C, device=table.counts.device) < table.counts[..., None]
    )
    idx = torch.where(
        valid, table.addrs.long(), torch.full_like(table.addrs.long(), num_addrs)
    )
    vals = torch.where(valid, table.values.to(torch.float32), 0.0)
    lead = tuple(table.addrs.shape[:-1])
    flat_idx = idx.reshape(-1, C)
    dense = torch.zeros(
        (flat_idx.shape[0], num_addrs + 1),
        dtype=torch.float32,
        device=flat_idx.device,
    )
    dense.scatter_add_(1, flat_idx, vals.reshape(-1, C))
    return dense[:, :num_addrs].reshape(lead + (num_addrs,))
