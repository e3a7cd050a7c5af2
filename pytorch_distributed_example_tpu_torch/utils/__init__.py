from .logger import DDPLogger, ProcessGroupStatus  # noqa: F401
from .flight_recorder import FlightRecorder, DebugInfoWriter  # noqa: F401
from .watchdog import Watchdog, HeartbeatMonitor  # noqa: F401
from .retry import RetryPolicy, call_with_retry, is_retryable  # noqa: F401
