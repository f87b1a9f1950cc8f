"""Parallelism: device meshes, data-parallel fitting, process groups.

Port of ``photon_tpu/parallel/``: ``mesh.py`` (meshes, row shards, the
deterministic fold), ``spmd_objective.py`` and ``data_parallel.py`` (the
fixed effect over row shards), ``model_parallel.py`` (the fixed effect over
a ``data`` x ``model`` mesh, its coefficients sharded), ``distributed.py``
(bring-up, file shards, process-local batches and the elastic
``MeshMembership``) and ``elastic.py`` (elastic multi-host GAME training,
``python -m photon_tpu_torch.parallel.elastic``).
"""
from photon_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    DCN_AXIS,
    ENTITY_AXIS,
    FEATURE_AXIS,
    Mesh,
    RowShards,
    axes_size,
    axis_tuple,
    fold,
    make_mesh,
    make_multislice_mesh,
    pad_and_shard_batch,
    pad_rows_to_multiple,
)
from photon_tpu_torch.parallel.data_parallel import (  # noqa: F401
    fit_data_parallel,
    spmd_value_and_grad,
)
from photon_tpu_torch.parallel.spmd_objective import (  # noqa: F401
    SpmdGLMObjective,
    fit_spmd,
)
from photon_tpu_torch.parallel.distributed import (  # noqa: F401
    global_batch_from_local,
    initialize_distributed,
    multihost_mesh,
    process_file_shard,
)
