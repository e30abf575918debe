"""aligngraph2_tpu_torch — the PyTorch/CUDA port of ``aligngraph2_tpu``.

The JAX package beside this one is the reference; each module here keeps
its counterpart's relative path and names it in its docstring.  This
package imports ``torch`` and numpy, never ``jax`` and never a module of
``aligngraph2_tpu``.

Ported so far: the seed-extend aligner (``align/aligner.py``) with host
seeding in C++ (``ops/seedextend.py``, ``native/seedhits.cpp``), the
adaptive-band DP in torch (``ops/banded_dp.py``) and the static-band DP
and its traceback as CUDA kernels for Hopper (``ops/banded_static.py``,
``csrc/banded_static.cu``).  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
