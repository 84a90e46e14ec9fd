"""K4: the RG-LRU linear-recurrence scan kernel (see ``kernel.py``)."""
