"""Scale-space detection, dense descriptors, CUDA kernels, matching, tracking."""
