"""One reader a metric, named as the metric is in BENCHMARK.json: each
module's `read(run)` takes the harness's Run (benchmark/run.py) and
returns the metric's value, or None where the run holds nothing to read
(no such kernel in the trace, no such phase in the loop)."""
