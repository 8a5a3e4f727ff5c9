from .config import ServeConfig
from .instance import (ExecutableCache, FunctionInstance, State,
                       restore_group)
from .orchestrator import FunctionRecord, Orchestrator
from .router import (AdmissionError, Invocation, Router, RouterClosedError,
                     RouterConfig, percentile, summarize)
