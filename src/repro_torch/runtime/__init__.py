from .fault_tolerance import (FaultTolerantLoop, HeartbeatMonitor,  # noqa: F401
                              StepHungError, StragglerPolicy)
from .supervisor import (GoodputMeter, Supervisor, SupervisorEvent,  # noqa: F401
                         WorkerFault, analytic_goodput, checkpoint_cost_model)
