"""The benchmark of the PyTorch port (``repro_torch``): PHSFL training
rounds and the Eq. 18 head bank on one H100 a cell.  See README.md."""
