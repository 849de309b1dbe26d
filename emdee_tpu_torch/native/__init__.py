"""Native (C++) acceleration modules, loaded via ctypes (counterpart of
emdee_tpu/native/).

Two native components mirror the reference's native tier (SURVEY.md §2a):

- ``canon``  — colored-graph canonical labeling (the reference FFIs to the
  nauty C library, molecular_graphs.jl:75-80).
- ``chemio`` — PDB/XYZ parsing (the reference uses the Chemfiles C++ library,
  modelling.jl:8,236).

The C++ sources are the port's own copies of emdee_tpu/native/canon.cpp and
chemio.cpp, byte for byte.  Both have pure-Python fallbacks so the package
works without a compiler; `emdee_tpu_torch.native.build` compiles the
shared library on demand with g++.
"""

from emdee_tpu_torch.native import canon, chemio  # noqa: F401
