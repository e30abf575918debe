"""aligngraph2_tpu_torch — the PyTorch/CUDA port of ``aligngraph2_tpu``.

The JAX package beside this one is the reference; each module here keeps
its counterpart's relative path and names it in its docstring.  This
package imports ``torch`` and numpy, never ``jax`` and never a module of
``aligngraph2_tpu``.

Ported: everything the JAX package does.  The eight-stage pipeline
(``pipeline/driver.py``, ``cli.py``): stage 1's solid-k-mer counter
(``ops/kmer.py``), the seed-extend aligner of stages 2, 3, 4 and 7
(``align/aligner.py``) with host seeding in C++ (``ops/seedextend.py``,
``native/seedhits.cpp``), the static-band and adaptive-band DPs and
their tracebacks as CUDA kernels for Hopper (``ops/banded_static.py``,
``csrc/banded_static.cu``; ``ops/banded_dp.py``,
``csrc/banded_adaptive.cu``), each beside its plain torch version,
the grouping, graph and traversal of stages 5 and 6 (``pipeline/``,
``graph/``, ``traverse/``, C++ cores ``native/ingest.cpp`` and
``native/traverse.cpp``) and the host consensus of stage 8
(``consensus/``, ``native/poacns.cpp``), with stage 6's merges and stage
8's aggregation also as torch ops on the card (``graph/merge_device.py``,
``consensus/device.py``), picked by a link probe (``utils/devprobe.py``).
The mesh path (``parallel/``): device seeding over a block-sharded
genome index and the adaptive band over every card, and multi-process
runs over ``torch.distributed``.  Entry points run on the CUDA device
unless the caller asks for the CPU.
"""

__version__ = "0.1.0"


def _tune_host_allocator() -> None:
    """Keep large freed blocks in the heap instead of munmapping them.

    The pipeline's host side (numpy SoA tables, alignment batches)
    allocates and frees many multi-MB arrays; with glibc's default
    M_MMAP_THRESHOLD each one is a fresh mmap whose first-touch page
    faults dominate on virtualized hosts.  Raising the mmap/trim
    thresholds makes the arena reusable: the fault cost is paid once per
    high-water mark.  Copy of ``_tune_host_allocator`` in
    ``aligngraph2_tpu/__init__.py``; set ALIGNGRAPH2_TPU_TORCH_NO_MALLOPT=1
    to opt out."""
    import os
    if os.environ.get("ALIGNGRAPH2_TPU_TORCH_NO_MALLOPT") == "1":
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
        libc.mallopt.restype = ctypes.c_int
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        # mallopt's value is a C int, so the largest representable
        # threshold is INT_MAX (~2 GB); that already keeps the GB-scale
        # merge scratch (native/ingest.cpp works on ~1.2 GB blocks at
        # 50M positions) heap-resident instead of re-paying first-touch
        # faults on every mmap/munmap cycle.
        libc.mallopt(M_TRIM_THRESHOLD, 0x7FFFFFFF)
        libc.mallopt(M_MMAP_THRESHOLD, 0x7FFFFFFF)
    except (OSError, ctypes.ArgumentError):
        pass


_tune_host_allocator()
