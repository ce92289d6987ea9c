from graphtap.engine.program import VertexProgram
from graphtap.engine.executor import Executor

__all__ = ["VertexProgram", "Executor"]
