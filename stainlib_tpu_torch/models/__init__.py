"""The port's models: the residual-flow + GMM colour model (``flow_layers``,
``resflow``, ``gmm``) and its trainer (``train_flow``). Importing it builds
nothing and starts no process group."""
