from .mesh import Mesh, make_mesh, replicate, shard_batch
from .runner import CorpusRunner, wash_corpus

__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "CorpusRunner", "wash_corpus"]
