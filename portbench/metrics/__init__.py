"""One reader a per-layer metric, found by its name: metrics/<name>.py's
`read(ctx)` takes the traced run's context (ctx.trace: the device trace
of the traced calls; ctx.steps: the steps traced; ctx.capture_ms;
ctx.least: the metric's own least ms over the traced steps, None where
it has none) and returns the metric, or None where it finds nothing to
read. A roofline's reader also has `least(st, cfg, s)`: the least time
(ms, what binds it) of its layer in one step, from the frozen yardstick
(core/yardstick.py) on what the reference's step hands its on_step
(None where the step does not run the layer)."""
