from mat_dcml_tpu_torch.telemetry.registry import HistogramSketch, Telemetry

__all__ = ["HistogramSketch", "Telemetry"]
