"""Per-layer metric readers, one file a metric: ``read(data)`` returns the
metric from the run's spans, counters and device trace, or None when the
run gives it nothing to read (a share of a peak or a roofline is never
reported as 0)."""
