"""The comparison that decides `correct` fails where it should.

The control, the program with its refinement switched off (its float32
solve alone, `benchmark.readings.CONTROL`), comes out not correct in every
cell; so does a run whose timed path is broken underneath, once for each
fault a solve cell can have: the state returned unchanged, half the batch
left out (its lanes carrying the other half's answers), and an answer
altered where it is produced. (A cell on one chip has no exchange between
chips to leave out.) On the CPU these run at the tiny size, the harness's
look for a card skipped; on the card the control runs at each cell's own
size."""

from __future__ import annotations

import pytest
import torch

import fbstab_tpu_torch as fb
from benchmark.readings import CONTROL
from benchmark.run import ROOT, Loader, run_cell

from .conftest import cells

SEED = 2 ** 32 + 77


def _pairs(x, fn):
    """fn applied to every tensor of a solution (both halves of a
    double-float pair)."""
    def each(a):
        return tuple(fn(t) for t in a) if isinstance(a, tuple) else fn(a)
    return type(x)(*(each(a) for a in x))


def unchanged(x, z0, l0, v0):
    zero = torch.zeros_like
    if isinstance(x.z, tuple):
        return type(x)(z=(z0, zero(z0)), l=(l0, zero(l0)), v=(v0, zero(v0)),
                       y=x.y)
    return type(x)(z=z0, l=l0, v=v0, y=x.y)


def half_left_out(x, *_):
    def fill(t):
        t = t.clone()
        h = t.shape[0] // 2
        t[h:] = t[:t.shape[0] - h]
        return t
    return _pairs(x, fill)


def altered(x, *_):
    def bump(t):
        return t + 1e-3
    z = x.z
    z = (bump(z[0]), z[1]) if isinstance(z, tuple) else bump(z)
    return x._replace(z=z)


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "altered": altered}


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_tiny(tiny, cell):
    out = run_cell(tiny, cell, SEED, 0, False, "cpu", overrides=CONTROL)
    assert not out["correct"], out["checks"]
    assert run_cell(tiny, cell, SEED, 0, False, "cpu")["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    real = fb.solve_mpc_qp_batch

    def broken(data, z0, l0, v0, options, **kw):
        x, core = real(data, z0, l0, v0, options, **kw)
        return FAULTS[fault](x, z0, l0, v0), core

    monkeypatch.setattr(fb, "solve_mpc_qp_batch", broken)
    out = run_cell(tiny, cell, SEED, 0, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    loader, dev = Loader(ROOT), torch.device("cuda", 0)
    assert run_cell(loader, cell, SEED, 0, False, dev)["correct"]
    out = run_cell(loader, cell, SEED, 0, False, dev, overrides=CONTROL)
    assert not out["correct"], out["checks"]
