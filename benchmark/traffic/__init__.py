"""Traffic kinds: ``<kind>.py`` holds ``run(ctx) -> harness.Outcome``, the
generator, the driver of the window and the end-to-end arithmetic of one
kind of traffic; a cell's ``workloads/<cell>.json`` gives its
parameters."""
