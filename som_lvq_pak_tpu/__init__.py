"""som_lvq_pak_tpu — a SOM/LVQ vector-quantization framework for accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the classic
Helsinki LVQ_PAK 3.1 / SOM_PAK 3.1 toolbox (reference: /root/reference).
The scalar winner-search loops of the reference become batched distance
matmuls fused with argmin and scatter updates; the host-side toolbox
(file format, label interning, pipelines, CLI) is rebuilt as framework code.

Layers (see SURVEY.md for the reference layer map):
  data/      text data/codebook format, label interning, datasets as arrays
  ops/       distance + top-k + neighborhood ops (exact parity, XLA, and the
             Pallas-Triton winner kernel for the GPU)
  models/    SOM and LVQ trainers, initializers, evaluators
  parallel/  device-mesh sharding: codebook-sharded winner search
  viz/       sammon / umat / planes EPS emitters
  cli/       the `somvq` multi-tool CLI covering every reference program
"""

__version__ = "0.1.0"

# Version string parity: reference version.c:5-11 reports
# "SOM/LVQ_PAK library version 3.2alpha".
REFERENCE_VERSION = "3.2alpha"


def get_version() -> str:
    """Framework version string (reference: version.c:5-11)."""
    return f"som_lvq_pak_tpu {__version__} (capability parity with SOM/LVQ_PAK {REFERENCE_VERSION})"
