from .mesh import Mesh, make_mesh, shard_batch, replicate_tree
