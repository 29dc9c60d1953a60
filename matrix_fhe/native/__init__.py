"""Native (C++) host-side components, loaded via ctypes.

The reference's host runtime is CUDA-C++; this framework keeps its
one-time heavy host work native too (tablegen.cpp), with pure-Python
fallbacks used transparently when no compiler is available.
"""
