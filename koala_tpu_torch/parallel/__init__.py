from .mesh import Mesh, make_mesh, replicate, shard_batch, shard_state
from .runner import CorpusRunner, wash_corpus

__all__ = ["Mesh", "make_mesh", "shard_batch", "shard_state", "replicate", "CorpusRunner",
           "wash_corpus"]
