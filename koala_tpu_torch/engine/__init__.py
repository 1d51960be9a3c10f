from .core import Engine, make_engine
from .stream import Koala
from .batch import KoalaBatch

__all__ = ["Engine", "make_engine", "Koala", "KoalaBatch"]
