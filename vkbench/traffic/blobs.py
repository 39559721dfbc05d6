"""Op kind ``blobs``: a block's blob sidecars, as EIP-4844 builds them.

For each of ``blobs`` seeded blobs: ``KZG.commit``, then the challenge z
from EIP-4844's ``compute_challenge`` over the blob and the commitment
(SHA-256, so z lies outside the domain), then ``KZG.prove_point`` at z.
The answer is each blob's (commitment, proof, y). The KZG secret is drawn
from the seed, in the place of a ceremony's.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

from vkbench.reference import bn254 as E
from vkbench.reference import kzg as ref

_KZG = "verkle_kzg_tpu_torch.schemes.kzg"
_POLY = "verkle_kzg_tpu_torch.poly.lagrange"

SPANS = [
    {"module": _KZG, "attr": "KZG.commit", "tag": "kzg.commit"},
    {"module": _KZG, "attr": "KZG.prove_point", "tag": "kzg.prove"},
    {"module": _POLY, "attr": "FrVector.evaluate", "tag": "poly.evaluate"},
    {"module": _POLY, "attr": "FrVector.divide_by_vanishing_outside", "tag": "poly.quotient"},
    {"module": "verkle_kzg_tpu_torch.ops.curve", "attr": "projective_to_host_points", "tag": "curve.to_host"},
]


def make_inputs(cfg: dict, wl: dict, seed: int) -> dict:
    """The secret, and per input of the pool ``blobs`` blobs of
    ``field_elements_per_blob`` elements of Fr."""
    rng = random.Random(seed)
    n = int(cfg["field_elements_per_blob"])
    secret = rng.randrange(n + 1, E.R)
    pool = [[[rng.randrange(E.R) for _ in range(n)] for _ in range(int(wl["blobs"]))]
            for _ in range(int(wl["pool"]))]
    return {"secret": secret, "pool": pool}


def prepare(cfg: dict, wl: dict, inputs: dict, device: str) -> SimpleNamespace:
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import kzg_setup

    n = int(cfg["field_elements_per_blob"])
    params = kzg_setup(n, secret=inputs["secret"], device=device)
    params.lagrange_affine  # the SRS on the card, once
    pool = [[(FrVector.from_ints(vals, params.domain, device=device), ref.blob_bytes(vals)) for vals in block]
            for block in inputs["pool"]]
    return SimpleNamespace(params=params, pool=pool)


def run(state: SimpleNamespace, i: int) -> tuple:
    from torch.profiler import record_function

    from verkle_kzg_tpu_torch.schemes import KZG

    out = []
    for fv, raw in state.pool[i]:
        c = KZG.commit(state.params, fv)
        with record_function("vk.eip4844.challenge"):
            z = ref.compute_challenge(raw, fv.domain.size, c)
        p = KZG.prove_point(state.params, c, z, fv)
        out.append((c, p.proof, p.y))
    return tuple(out)


def expected(cfg: dict, wl: dict, inputs: dict, truncate: bool = False) -> list:
    omegas = E.domain(int(cfg["field_elements_per_blob"]))
    return [tuple(ref.blob_sidecar(vals, inputs["secret"], omegas, truncate) for vals in block)
            for block in inputs["pool"]]
