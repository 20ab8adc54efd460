from .engine import CompressionEngine, PrefillResult
from .telemetry import CompressionEvent, PrefillTelemetry

__all__ = ["CompressionEngine", "PrefillResult", "CompressionEvent", "PrefillTelemetry"]
