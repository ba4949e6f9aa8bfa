"""Carries problem data and options across from the JAX package.

Both helpers take plain Python / numpy values, so neither imports JAX:
the tests pass `MpcQPData` leaves of `fbstab_tpu` as numpy arrays and
`dataclasses.asdict(fbstab_tpu.Options(...))`, and both packages then
solve the same problem with the same options.
"""

from __future__ import annotations

import torch

from fbstab_tpu_torch.models.mpc_qp import MpcQPData, mpc_qp_data
from fbstab_tpu_torch.options import Display, Options


def mpc_data_from_arrays(dtype=torch.float64, device=None,
                         **arrays) -> MpcQPData:
    """The port's batched MpcQPData from the twelve MpcQPData leaves (Q, R,
    S, q, r, A, B, c, E, L, d, x0) as arrays with a leading batch axis."""
    missing = set(MpcQPData._fields) - set(arrays)
    extra = set(arrays) - set(MpcQPData._fields)
    if missing or extra:
        raise ValueError(f"mpc_data_from_arrays: missing {sorted(missing)}, "
                         f"unexpected {sorted(extra)}")
    return mpc_qp_data(dtype=dtype, device=device, **arrays)


def options_from_fields(fields: dict) -> Options:
    """The port's Options from the fields of a `fbstab_tpu.Options`."""
    kw = dict(fields)
    if "display_level" in kw:
        kw["display_level"] = Display(int(kw["display_level"]))
    return Options(**kw)
