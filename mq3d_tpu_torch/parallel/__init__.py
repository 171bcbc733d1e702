"""Multi-device and batch-of-sessions paths on torch.distributed.

Counterpart of mq3d_tpu/parallel/.  The JAX package shards over a
`jax.sharding.Mesh` inside one SPMD program; here each rank is a process
and a `torch.distributed` process group takes the mesh's place (dist.py).

  dist.py       process groups, spawning ranks with a deadline, collectives
  sharded.py    frame-sharded TSDF integration, confidence and raycast
  multihost.py  capture sessions sharded over hosts, status roll-up
  dryrun.py     the sharded paths once at tiny and at production shapes
"""
