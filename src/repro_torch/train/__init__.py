"""The training substrate of the port — ``repro.train``'s checkpoint
manager, gradient compression, trainer and elastic resharding
(``elastic``: a train state re-placed on a new mesh, a sharded graph and
its vertex arrays on a new shard count)."""
