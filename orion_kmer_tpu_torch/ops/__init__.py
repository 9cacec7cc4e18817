"""Device ops of the port: extraction (K1), run merge (K2), compaction
(K3), block sort (K4), the radix sort of whole batches (``radix.py``),
and what is built from them: the count pipeline
(``count.py``) and the set joins (``setops.py``).

Each kernel module holds the wrapper, its plain PyTorch version and a
launch counter.  The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel of ``csrc/`` or raises.
"""
