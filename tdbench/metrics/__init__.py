"""One reader a metric, in ``<metric name>.py``: ``read(run)`` returns the
metric's value from a finished run (``tdbench.run.RunRecord``), or None
where the run holds nothing to read; the harness then leaves the metric
out of the result line."""
