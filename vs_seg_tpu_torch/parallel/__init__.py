"""Several shards in one process: the device mesh (mesh.py) and the
collectives between the shards' threads (collectives.py). Several processes,
one per GPU: data-parallel training over torch.distributed
(distributed.py)."""
