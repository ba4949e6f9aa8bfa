"""The plain float64 reference of the MPC configurations: the penalized
natural residual of a returned primal-dual point, worked out from the
benchmark's own inputs.

The contract of `Options.single_precision()` is that a lane that exits
SUCCESS with its reported residual at most 1e-6 has a float64 penalized
natural residual of at most 1e-6 on the data it was given. This module
rebuilds that data from the frozen plant (`benchmark.plants`) and the
initial states the run drew, rounded to float32 exactly as they were
handed to the program, and evaluates the residual of the point the
program returned, in float64, lane by lane:

    rz = f + H z + G' l + A' v,   rl = h - G z,
    rv = alpha min(y, v) + (1 - alpha) max(0, y) max(0, v),  y = b - A z,

with the stage structure of the MPC class written out. The formula is a
frozen copy of `fbstab_tpu_torch.workloads.mpc_f64_residual` at commit
326587a, on a plant shared by every lane. It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import plants


def stacked_f32(stacked: dict) -> dict:
    """The stacked plant as the program received it: each array rounded to
    float32, held as float64."""
    return {k: np.asarray(v, np.float32).astype(np.float64)
            for k, v in stacked.items()}


def residual(plant: dict, x0, z, l, v, alpha: float) -> torch.Tensor:
    """Per-lane float64 penalized natural residual. `plant` holds the
    stacked arrays of one instance (numpy or tensors; float32 values held
    as float64); x0 (B, nx), z (B, (N+1)(nx+nu)), l (B, (N+1) nx) and
    v (B, (N+1) nc) are float64 tensors on one device."""
    dev = z.device
    P = {k: torch.as_tensor(np.asarray(a), dtype=torch.float64, device=dev)
         for k, a in plant.items()}
    B = z.shape[0]
    N1, nx = P["Q"].shape[0], P["Q"].shape[-1]
    nu, nc = P["R"].shape[-1], P["E"].shape[1]
    zs = z.reshape(B, N1, nx + nu)
    zx, zu = zs[..., :nx], zs[..., nx:]
    ls = l.reshape(B, N1, nx)
    vs = v.reshape(B, N1, nc)
    ein = torch.einsum
    hx = ein("sij,bsj->bsi", P["Q"], zx) + ein("sji,bsj->bsi", P["S"], zu)
    hu = ein("sij,bsj->bsi", P["S"], zx) + ein("sij,bsj->bsi", P["R"], zu)
    atl = ein("sji,bsj->bsi", P["A"], ls[:, 1:])
    btl = ein("sji,bsj->bsi", P["B"], ls[:, 1:])
    zero = lambda n: torch.zeros(B, 1, n, dtype=torch.float64, device=dev)
    gx = -ls + torch.cat([atl, zero(nx)], 1)
    gu = torch.cat([btl, zero(nu)], 1)
    ax = ein("sci,bsc->bsi", P["E"], vs)
    au = ein("sci,bsc->bsi", P["L"], vs)
    rzx = P["q"] + hx + gx + ax
    rzu = P["r"] + hu + gu + au
    gzt = (ein("sij,bsj->bsi", P["A"], zx[:, :-1])
           + ein("sij,bsj->bsi", P["B"], zu[:, :-1]) - zx[:, 1:])
    gz = torch.cat([-zx[:, :1], gzt], 1)
    c = P["c"].expand(B, -1, -1)
    rl = -torch.cat([x0[:, None, :], c], 1) - gz
    az = ein("sci,bsi->bsc", P["E"], zx) + ein("sci,bsi->bsc", P["L"], zu)
    y = -P["d"] - az
    rv = (alpha * torch.minimum(y, vs)
          + (1 - alpha) * torch.clamp(y, min=0) * torch.clamp(vs, min=0))
    sq = lambda a: (a.reshape(B, -1) ** 2).sum(1)
    return torch.sqrt(sq(rzx) + sq(rzu) + sq(rl) + sq(rv))


def check(samples: list, config: dict, device, find,
          block: int = 512) -> dict:
    """The worst float64 residual among the sampled lanes that the program
    reported as meeting the contract (exit flag SUCCESS, reported residual
    at most contract["residual"]), how many such lanes there were, and,
    for the record, the worst among all sampled lanes that exit SUCCESS,
    the largest relative excess of the float64 residual over the reported
    one among the claimed lanes, and how many of them the program reported
    within a thousandth below the contract.

    Each sample holds float64 arrays of one call's checked lanes: x0, z,
    l, v, and the program's eflag and reported residual. The lanes are
    evaluated in blocks of `block` on `device`. The plant is the
    configuration's, found by name and stacked over its horizon."""
    contract = config["contract"]
    plant = stacked_f32(plants.stack(find("plants", config["plant"]).plant(),
                                     int(config["horizon"])))
    cat = lambda k: np.concatenate([np.asarray(s[k]) for s in samples])
    if not samples:
        return dict(residual_max=None, checked_lanes=0,
                    residual_max_success=None, residual_gap_max=None,
                    near_limit_lanes=0)
    arrs = {k: cat(k) for k in ("x0", "z", "l", "v", "eflag", "residual")}
    success = arrs["eflag"] == 0
    claimed = success & (arrs["residual"] <= contract["residual"])
    res = np.full(len(success), np.nan)
    rows = np.flatnonzero(success)
    for i in range(0, len(rows), block):
        r = rows[i:i + block]
        t = {k: torch.as_tensor(arrs[k][r], dtype=torch.float64,
                                device=device) for k in ("x0", "z", "l", "v")}
        res[r] = residual(plant, t["x0"], t["z"], t["l"], t["v"],
                          contract["alpha"]).cpu().numpy()
    worst = lambda m: float(res[m].max()) if m.any() else None
    rep = arrs["residual"]
    gap = (res - rep) / np.maximum(rep, np.finfo(float).tiny)
    near = claimed & (rep > contract["residual"] * (1 - 1e-3))
    return dict(residual_max=worst(claimed), checked_lanes=int(claimed.sum()),
                residual_max_success=worst(success),
                residual_gap_max=(float(gap[claimed].max()) if claimed.any()
                                  else None),
                near_limit_lanes=int(near.sum()))
