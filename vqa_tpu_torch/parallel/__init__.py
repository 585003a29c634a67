"""Multi-device: the (data, model) grid of ranks, the tensor-parallel rules
and the multi-process runtime (counterpart of ``vqa_tpu/parallel``)."""

from vqa_tpu_torch.parallel import distributed  # noqa: F401
from vqa_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    data_sharding,
    mesh_from_config,
    param_spec,
    replicated,
    variables_shardings,
)


def shard_variables(model, mesh):
    """Split ``model``'s tensor-parallel blocks over ``mesh``, in place
    (``models.vqa_model.shard_model``)."""
    from vqa_tpu_torch.models.vqa_model import shard_model

    return shard_model(model, mesh)
