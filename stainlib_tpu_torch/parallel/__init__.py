"""The port's distributed layer: process groups and named device meshes
(``mesh``), the Horovod-style collectives over a mesh axis
(``collectives``) and the sharded stain paths (``stain_sharded``), on
``torch.distributed`` (NCCL on CUDA, gloo on the CPU). Importing it starts
no process group."""
