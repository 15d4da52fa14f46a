"""One runner per kind of traffic; a traffic file (portbench/traffic/) names
its runner and gives its parameters. A runner is constructed with the cell,
the run's seed and the device, and has `setup()`, `window(seconds)`,
`traced()`, `release()` and `check()` (see portbench/run.py)."""
