"""Sharding across cards over ``torch.distributed`` (``verkle_kzg_tpu/parallel``):
one rank a card, NCCL between them. Point and scalar vectors are split
across the ranks, and the partial results ride the collectives; see
``mesh.py`` and ``ntt.py``."""

from .mesh import make_mesh, msm_batched_sharded, msm_sharded
from .ntt import intt_fr_sharded, ntt_fr_sharded

__all__ = [
    "make_mesh",
    "msm_sharded",
    "msm_batched_sharded",
    "ntt_fr_sharded",
    "intt_fr_sharded",
]
