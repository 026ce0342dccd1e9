"""Traffic drivers: ``<driver>.py`` has ``UNITS`` (its end-to-end metrics)
and ``run(run) -> harness.Outcome``; a workload file names its driver and
gives its parameters."""
