"""The port's data layer: the native slide readers (``native``), the
device prefetch ring (``pipeline``), pyramid preprocessing and dataset
manifests. Importing it builds nothing."""
