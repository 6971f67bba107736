"""Exporters of the port: ONNX writer, reader and checker, torch.export
programs, darknet weights, checkpoint surgery and reference conversions."""
