"""The port's training utilities: parameter EMA (``ema``), checkpoints
(``checkpoint``) and meters and rank-0 logging (``meters``)."""
