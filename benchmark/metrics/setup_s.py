"""Seconds from the start of the process to the first timed call: the
imports, the CUDA context, the program's library (built on the first run
in a checkout, loaded after), the inputs and the loop's warm-up."""


def read(run):
    return run.setup_s
