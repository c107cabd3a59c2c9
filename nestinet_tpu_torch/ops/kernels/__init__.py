"""Hand-written CUDA kernels: nvcc build helper and ctypes wrappers.

Nothing here builds or loads a kernel at import time; the first launch
does.
"""
