"""Data parallelism over ``torch.distributed``, one process per device: the
mesh, the collectives the reference's GSPMD inserts, the sequence-parallel
Chamfer and the builder / trainer split (port of ``apr_tpu/parallel``)."""

from apr_torch.parallel.mesh import make_mesh, replicate, shard_batch
from apr_torch.parallel.pipeline import BuilderTrainerPipeline

__all__ = ["make_mesh", "shard_batch", "replicate",
           "BuilderTrainerPipeline"]
