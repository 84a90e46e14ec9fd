"""K2: the flash attention forward kernel (see ``kernel.py``)."""
