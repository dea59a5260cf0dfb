"""lariat_tpu_torch: the linked-read aligner on PyTorch and CUDA (Hopper).

A port of ``lariat_tpu``'s device-primed candidate-generation pass. The
host layers (index, FASTQ/BAM I/O, the C++ replay sessions' bindings, RFA
and the worker pool) are copies of ``lariat_tpu``'s, under the same
sub-package names, without their JAX branches; the DP waves run as
hand-written CUDA kernels for ``sm_90a`` (``csrc/*.cu``), each with a
plain PyTorch twin that the CPU tests hold against the JAX package.

Nothing here imports JAX or any module of ``lariat_tpu``: importing
``lariat_tpu`` rewrites JAX's platform variables for the whole process.
"""

__version__ = "0.1.0"
