"""Build the native FASTA/FASTQ parsers once, before any test worker starts.

Both packages compile their parser at first use.  Under pytest-xdist every
worker would do so at once on a fresh checkout, and the JAX package's build
writes through one temporary path shared by all processes, so concurrent
builds corrupt each other and leave workers on the Python parser.  The
controller process builds both libraries here, alone; the workers then
find them finished.  ``ORION_KMER_BUILD_DIR`` is honoured by the JAX
package's module itself.
"""

import logging
import sys


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built already
    from orion_kmer_tpu.ingest import native as jax_native
    from orion_kmer_tpu_torch.ingest import native as port_native

    to_stderr = logging.StreamHandler(sys.stderr)  # a failed build is logged by the module, with its cause
    for name, native in (("orion_kmer_tpu", jax_native), ("orion_kmer_tpu_torch", port_native)):
        native.logger.addHandler(to_stderr)
        try:
            built = native.available()
        finally:
            native.logger.removeHandler(to_stderr)
        if not built:
            print(f"conftest: the native parser of {name} is unavailable "
                  "(its build failed, or ORION_KMER_NATIVE=0)", file=sys.stderr)
