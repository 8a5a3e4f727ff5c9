from .config import ServeConfig
from .forecast import ForecastConfig, ForecastDemand, PeriodicityDetector
from .instance import (ExecutableCache, FunctionInstance, State,
                       restore_group)
from .loadgen import (ClosedLoopGenerator, OpenLoopGenerator, Trace,
                      TraceEvent, azure_trace, diurnal_trace, poisson_trace,
                      uniform_trace)
from .orchestrator import FunctionRecord, Orchestrator
from .policy import FunctionDemand, PolicyConfig, PrewarmPolicy
from .router import (AdmissionError, Invocation, Router, RouterClosedError,
                     RouterConfig, percentile, summarize)
