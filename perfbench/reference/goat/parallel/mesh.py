"""One process: no mesh."""


class Mesh:
    size, rank = 1, 0


def shard_batch(batch, mesh):
    return batch
