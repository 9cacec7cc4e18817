"""Device ops of the port: extraction (K1), run merge (K2), compaction
(K3), and the count pipeline built from them (``count.py``).

Each kernel module holds the wrapper, its plain PyTorch version and a
launch counter.  The wrapper takes the plain version only for CPU
tensors; for CUDA tensors it launches the kernel of ``csrc/`` or raises.
"""
