"""K1: the fused quantize-dequantize kernel (see ``kernel.py``)."""
