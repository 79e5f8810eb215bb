"""I/O: processed-AMISR reader, coefficient files, synthetic data.

h5py is imported inside the functions that touch files, so the package and
its in-memory paths work where h5py is not installed."""
