from visual_sgraphs.utils.events import EventLog
from visual_sgraphs.utils.timing import StageTimers

__all__ = ["EventLog", "StageTimers"]
