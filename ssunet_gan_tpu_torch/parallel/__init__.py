"""Data parallelism over ``torch.distributed`` (the JAX package's
parallel/): the mesh, batch sharding and replication, and the multi-host
start-up. The collectives the steps use are ``ops/collectives.py``."""

from ssunet_gan_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    average_gradients,
    check_mesh,
    initialize_multihost,
    make_mesh,
    pmean_metrics,
    replicate,
    shard_batch,
    sharded_step,
)
