from .fault_tolerance import (FaultTolerantLoop, HeartbeatMonitor,  # noqa: F401
                              StepHungError, StragglerPolicy)
