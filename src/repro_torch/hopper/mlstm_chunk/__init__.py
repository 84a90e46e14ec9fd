"""K3: the chunkwise mLSTM forward kernel (see ``kernel.py``)."""
