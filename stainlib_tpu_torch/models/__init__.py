"""The port's models: the residual-flow + GMM colour model (``flow_layers``,
``resflow``, ``gmm``), its trainer (``train_flow``), its deployment and
evaluation (``color_eval``, ``validate_flow``), sampling (``sampling``),
the toy 2-D flow (``toy``), the U-Net segmenter (``segmentation``) and the
stain-adversarial DANN family (``dann``, ``backbones``, ``evaluation``,
``train_dann``; shared layers in ``_nets``). Importing it builds nothing
and starts no process group."""
