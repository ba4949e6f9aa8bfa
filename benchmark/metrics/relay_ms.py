"""Mean milliseconds a closed-loop step spends in its relay: the plant
update and the shifted warmstart, timed from the synchronized end of the
solve to the synchronized end of the relay, before the benchmark reads
the step's counts and checked lanes (traced runs only)."""


def read(run):
    relay = [c["relay_s"] for c in run.calls if "relay_s" in c]
    if not relay:
        return None
    return 1e3 * sum(relay) / len(relay)
