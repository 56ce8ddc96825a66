"""annsearch_tpu — approximate nearest-neighbour search in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capability surface of
``GregorLueg/ann-search-rs`` (pure-Rust ANN library): flat/IVF/tree/LSH/graph
indexes, quantised (bf16/sq8/pq/opq) and binary (simhash/pca/sign/RaBitQ)
variants, under squared-euclidean and cosine distance — redesigned as
batched matmul and top-k programs for an accelerator rather than
translated from SIMD+rayon.

Layout:
  * ``ops``      — distance matmuls, running top-k, quantised scan kernels
  * ``models``   — index implementations
  * ``parallel`` — mesh sharding (multi-chip query/build)
  * ``utils``    — metrics, synthetic data, validation
"""

from .lib import *  # noqa: F401,F403
from .lib import __all__ as _lib_all
from .utils import Dist, parse_ann_dist  # noqa: F401
from .utils.metrics import calculate_recall  # noqa: F401
from .utils.validation import validate_index  # noqa: F401

__version__ = "0.1.0"
__all__ = list(_lib_all) + [
    "Dist", "parse_ann_dist", "validate_index", "calculate_recall",
]
