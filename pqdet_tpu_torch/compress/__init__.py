"""Quantisation: QAT fake-quant and observers (``qat``), int8 conversion and
the int8 executor (``quantized``)."""
