"""Meshes of shards over one or several processes, the sharded LM
solvers and the branch-and-bound fan-out, on ``torch.distributed``."""
