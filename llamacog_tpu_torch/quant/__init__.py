from .wire import WireTensor, dequantize, dequantize_rows

__all__ = ["WireTensor", "dequantize", "dequantize_rows"]
