"""Carries problem data and options across from the JAX package.

Every helper takes plain Python / numpy values, so none imports JAX: the
tests pass `MpcQPData` / `DenseQPData` / `SparseQPData` leaves of
`fbstab_tpu` as numpy arrays and
`dataclasses.asdict(fbstab_tpu.Options(...))`, and both packages then
solve the same problem with the same options. The data goes on the card
unless `device` says otherwise (device.resolve_device).
"""

from __future__ import annotations

import numpy as np
import torch

from fbstab_tpu_torch.device import resolve_device
from fbstab_tpu_torch.models.dense_qp import DenseQPData, dense_qp_data
from fbstab_tpu_torch.models.mpc_qp import MpcQPData, mpc_qp_data
from fbstab_tpu_torch.models.sparse_qp import SparseQPData
from fbstab_tpu_torch.options import Display, Options


def _check_fields(fn, fields, arrays):
    missing = set(fields) - set(arrays)
    extra = set(arrays) - set(fields)
    if missing or extra:
        raise ValueError(f"{fn}: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")


def mpc_data_from_arrays(dtype=torch.float64, device=None,
                         **arrays) -> MpcQPData:
    """The port's batched MpcQPData from the twelve MpcQPData leaves (Q, R,
    S, q, r, A, B, c, E, L, d, x0) as arrays with a leading batch axis."""
    _check_fields("mpc_data_from_arrays", MpcQPData._fields, arrays)
    return mpc_qp_data(dtype=dtype, device=device, **arrays)


def dense_data_from_arrays(dtype=torch.float64, device=None,
                           **arrays) -> DenseQPData:
    """The port's batched DenseQPData from the six DenseQPData leaves (H, f,
    G, h, A, b) as arrays with a leading batch axis (G (B, 0, n) and
    h (B, 0) when there are no equality constraints)."""
    _check_fields("dense_data_from_arrays", DenseQPData._fields, arrays)
    return dense_qp_data(dtype=dtype, device=device, **arrays)


def sparse_data_from_arrays(dtype=torch.float64, device=None,
                            **arrays) -> SparseQPData:
    """The port's batched SparseQPData from the six SparseQPData leaves
    (Hx, f, Gx, h, Ax, b: the CSR value arrays and vectors of a pattern)
    as arrays with a leading batch axis. The values must be in the order
    of the port's pattern of the same matrices (the JAX package's
    sparse_qp_data and the port's order them alike)."""
    _check_fields("sparse_data_from_arrays", SparseQPData._fields, arrays)
    device = resolve_device(device)
    return SparseQPData(**{
        k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
        for k in SparseQPData._fields})


def options_from_fields(fields: dict) -> Options:
    """The port's Options from the fields of a `fbstab_tpu.Options`."""
    kw = dict(fields)
    if "display_level" in kw:
        kw["display_level"] = Display(int(kw["display_level"]))
    return Options(**kw)
