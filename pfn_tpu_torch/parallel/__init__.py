"""Device-mesh parallelism: the mesh, its sharding rules, the collectives,
and the pipeline (``pfn_tpu/parallel/``'s names). The pipeline's names load on
first use: ``parallel.pipeline`` imports the model, which imports the
collectives from here."""

from pfn_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    init_distributed,
    make_mesh,
    make_pp_mesh,
    param_sharding,
    replicate,
    token_sharding,
)

_PIPELINE = ("PipelinedPFN", "make_pp_train_step", "to_pipeline_params")


def __getattr__(name):
    if name in _PIPELINE:
        from pfn_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "make_mesh",
    "batch_sharding",
    "param_sharding",
    "replicate",
    "token_sharding",
    "PipelinedPFN",
    "make_pp_mesh",
    "make_pp_train_step",
    "to_pipeline_params",
    "Mesh",
    "init_distributed",
]
