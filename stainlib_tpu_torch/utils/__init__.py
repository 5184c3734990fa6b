"""The port's utilities: parameter EMA (``ema``), checkpoints
(``checkpoint``), meters and rank-0 logging (``meters``), profiler traces
and a blocking step timer (``profiling``), the stall watchdog
(``watchdog``) and the image-grid plot (``plot``, matplotlib imported at
first use)."""
