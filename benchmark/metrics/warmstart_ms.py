"""Device-timeline milliseconds a closed-loop step in the shifted
warmstart (the program's `fbstab.shift_warmstart` span: the shift of
every stage sequence and the margin's recomputation), from the stream
reaching the span to the end of its work."""

from benchmark import spans


def read(run):
    return spans.span_ms(run, "fbstab.shift_warmstart")
