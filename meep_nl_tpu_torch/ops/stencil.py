"""Shifted-slice stencil primitive (torch counterpart of
``meep_nl_tpu/ops/stencil.py::shift``).

The analog of the reference's strided pointer walks (`g1[i + s1]` in
step_generic.cpp:69) as whole-array shifts.  Out-of-range neighbors are zero
(the PEC / not-owned convention) unless the axis is Bloch-periodic, in which
case the wrapped plane is multiplied by the Bloch phase (the CONNECT_PHASE
class of boundaries.cpp:347).  Arrays may carry dead storage padding past
the live region; `nlive` is the number of live cells along the axis (the
periodic wrap distance).
"""

from __future__ import annotations

from typing import Optional

import torch


def shift(arr: torch.Tensor, axis: int, by: int, periodic: bool = False,
          phase=None, nlive: Optional[int] = None) -> torch.Tensor:
    """Return out with out[i] = arr[i + by] along `axis` (by in {-1, +1}).

    Non-periodic: vacated entries are zero.  Periodic: live cells are
    0..nlive-1 (indices >= nlive are dead ghosts, masked upstream); the
    wrapped plane is multiplied by `phase` (exp(+-i k L))."""
    if by == 0:
        return arr
    sdim = arr.shape[axis]
    out = torch.zeros_like(arr)
    if not periodic:
        if by > 0:
            out.narrow(axis, 0, sdim - by).copy_(arr.narrow(axis, by, sdim - by))
        else:
            out.narrow(axis, -by, sdim + by).copy_(arr.narrow(axis, 0, sdim + by))
        return out
    n = nlive if nlive is not None else sdim - 1
    rolled = torch.roll(arr.narrow(axis, 0, n), -by, dims=axis)
    out.narrow(axis, 0, n).copy_(rolled)
    if phase is not None:
        # the wrapped plane: the head's last `by` planes (by > 0) or the
        # first `-by` planes (by < 0) carry exp(+-i k L)
        wrap = out.narrow(axis, n - by, by) if by > 0 else out.narrow(axis, 0, -by)
        wrap.mul_(phase if by > 0 else 1.0 / phase)
    return out
