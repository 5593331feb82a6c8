from repro_torch.runtime.carbon_gate import CarbonGate  # noqa: F401
from repro_torch.runtime.fault import FailureInjector, run_with_restarts  # noqa: F401
from repro_torch.runtime.straggler import StragglerMonitor  # noqa: F401
