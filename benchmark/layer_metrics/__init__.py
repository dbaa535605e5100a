"""One reader a per-layer metric, found by the metric's name: `read(run)`
takes the traced run (`run.trace`, a `benchmark.trace.Trace`, and the
driver's counts) and returns the metric's value, or None where the trace
holds nothing it reads."""
