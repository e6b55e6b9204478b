"""Native host code of the port: the C++ walk sampler and the shared
build-and-load helper (also used for the CUDA kernels)."""
