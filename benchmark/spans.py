"""What the program's own spans and counters recorded in a traced window
(fbstab_tpu_torch/telemetry.py), as the per-layer metrics read it.

The program records spans only while a torch.profiler session is active,
and the harness profiles the window alone, so `recorded()` holds exactly
the window's calls. A program without that module, or a window in which
it recorded nothing, gives None: the metrics that read it stay silent."""

from __future__ import annotations


def recorded():
    """The program's spans by name (telemetry.recorded()), or None."""
    try:
        from fbstab_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.recorded() or None


def span_ms(run, name: str):
    """Device-timeline milliseconds a call in the spans named `name`."""
    rec = recorded() if run.trace is not None else None
    if not rec or name not in rec or rec[name]["device_s"] is None:
        return None
    return 1e3 * rec[name]["device_s"] / len(run.calls)


def counts(rec) -> dict:
    """The window's counters: each summed over the spans it was added
    in."""
    out = {}
    for s in rec.values():
        for k, n in s["counts"].items():
            out[k] = out.get(k, 0) + n
    return out
