"""Readers of metrics: each module's `read(run, **args)` returns the
metric's value for one run, or None where it finds nothing to read (the
metric is then left out of the run's line). `run` is `run.RunView`; the
arguments come from the metric's file, `metrics/<name>.json`."""
