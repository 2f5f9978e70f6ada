from .fitch import FastParsimony
from .sankoff import Parsimony, ParsBuildOp, ParsRecOp

__all__ = ["Parsimony", "FastParsimony", "ParsBuildOp", "ParsRecOp"]
