from .engine import CompressionEngine, PrefillResult
from .serving import ServeRequest, ServeResult, ServingLoop
from .spec_decode import draft_lookup, generate_spec, generate_spec_batch
from .telemetry import CompressionEvent, PrefillTelemetry

__all__ = ["CompressionEngine", "PrefillResult", "CompressionEvent", "PrefillTelemetry", "ServeRequest",
           "ServeResult", "ServingLoop", "draft_lookup", "generate_spec", "generate_spec_batch"]
