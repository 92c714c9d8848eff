"""Plain references, in PyTorch at float32 with TF32 off, that decide a cell's
``correct``. They import nothing of the program and take nothing it made:
weights and inputs come from the seed through :mod:`perfbench.harness`."""
