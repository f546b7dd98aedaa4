"""Data, tensor and sequence parallelism over ``torch.distributed``.

Port of ``torchcde_tpu/parallel/``: ``mesh`` (the (data, model)
``DeviceMesh``, batch sharding, tensor-parallel placement of the vector
field), ``seq_pcr`` (the dense tridiagonal solve with the length sharded)
and ``seq_masked`` (the NaN-masked natural-cubic fit with the length
sharded), over ``comm`` (the differentiable collectives) and ``launch``
(``run_ranks``, one process per rank).
"""

from .mesh import (
    NEURAL_CDE_TP_RULES,
    TensorParallelField,
    batch_sharding,
    make_mesh,
    neural_cde_param_sharding,
    param_sharding_rules,
    place_params,
    replicated,
    shard_batch,
)
from .seq_masked import natural_cubic_coeffs_seq_sharded
from .seq_pcr import tridiagonal_solve_seq_sharded

__all__ = [
    "NEURAL_CDE_TP_RULES",
    "TensorParallelField",
    "batch_sharding",
    "make_mesh",
    "natural_cubic_coeffs_seq_sharded",
    "neural_cde_param_sharding",
    "param_sharding_rules",
    "place_params",
    "replicated",
    "shard_batch",
    "tridiagonal_solve_seq_sharded",
]
