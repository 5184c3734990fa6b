"""The port's models: the residual-flow + GMM colour model (``flow_layers``,
``resflow``, ``gmm``), its trainer (``train_flow``), its deployment and
evaluation (``color_eval``, ``validate_flow``), sampling (``sampling``) and
the toy 2-D flow (``toy``). Importing it builds nothing and starts no
process group."""
