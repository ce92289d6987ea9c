from graphtap.tools.oracle import state_stats
from graphtap.tools.timing import PhaseTimer

__all__ = ["state_stats", "PhaseTimer"]
