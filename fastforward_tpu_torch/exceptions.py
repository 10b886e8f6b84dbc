"""Exception types of the port (`fastforward_tpu/exceptions.py`)."""


class QuantizationError(Exception):
    """Raised when a quantization invariant is violated.

    Most prominently raised by the strict-quantization checks when an operator
    would silently run unquantized or implicitly dequantize its inputs.
    """


class ExportError(Exception):
    """Raised when a model cannot be exported."""


class AutoquantError(Exception):
    """Raised when automatic quantized-op substitution fails."""
