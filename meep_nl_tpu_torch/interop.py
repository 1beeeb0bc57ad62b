"""Carry plan coefficients and field states between the JAX package and the
port, as numpy arrays.

The JAX package's state pytree and coefficient dict are handed over with
``np.asarray`` applied to each leaf; these helpers turn such a tree into the
port's tensors (and back), so that both packages can be stepped from one
identical state.  Dtypes and shapes are kept: complex64 fields of a
native complex state, and a real pair's (2, ...) float32 fields, whose
leading axis is the (re, im) channel in both packages; a gyrotropic
pole's off-axis entries (the `c#1` / `c#2` keys of its "p" and "pp") go
across with the rest.  Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _to_tensor(x, device):
    # a private copy: the JAX package's arrays are read-only buffers
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def coefs_from_numpy(coefs: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """{key: ndarray} -> {key: tensor on `device`} (dtypes kept)."""
    return {k: _to_tensor(v, device) for k, v in coefs.items()}


def coefs_to_numpy(coefs: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in coefs.items()}


def state_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A numpy state tree ({"f", "f_u", "f_cond", "f_w": {comp: arr},
    "pol": [{"p": {...}, "pp": {...}}], "dft": {...}, "t"}, and a BFAST
    run's "f_bfast": {comp: arr}) -> the port's state: tensors on `device`
    and an integer step counter."""
    out: Dict[str, Any] = {}
    for key in ("f", "f_u", "f_cond", "f_w", "dft"):
        out[key] = {c: _to_tensor(v, device)
                    for c, v in tree.get(key, {}).items()}
    if "f_bfast" in tree:
        out["f_bfast"] = {c: _to_tensor(v, device)
                          for c, v in tree["f_bfast"].items()}
    out["pol"] = [{"p": {c: _to_tensor(v, device) for c, v in e["p"].items()},
                   "pp": {c: _to_tensor(v, device)
                          for c, v in e["pp"].items()}}
                  for e in tree.get("pol", [])]
    out["t"] = int(np.asarray(tree.get("t", 0)))
    return out


def state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `state_from_numpy`."""
    def arr(v):
        return v.detach().cpu().numpy()

    out: Dict[str, Any] = {key: {c: arr(v) for c, v in state[key].items()}
                           for key in ("f", "f_u", "f_cond", "f_w", "dft",
                                       "f_bfast") if key in state}
    out["pol"] = [{"p": {c: arr(v) for c, v in e["p"].items()},
                   "pp": {c: arr(v) for c, v in e["pp"].items()}}
                  for e in state["pol"]]
    out["t"] = np.int32(state["t"])
    return out
