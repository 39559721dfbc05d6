"""Op kind ``fk_all``: every opening of one blob, by the amortized
Feist-Khovratovich prover.

The op is ``schemes.fk.prove_all_points(params, blob)``; the answer is the
proofs at every point of the domain with their y. The KZG secret is drawn
from the seed.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

from vkbench.reference import bn254 as E
from vkbench.reference import kzg as ref

_FK = "verkle_kzg_tpu_torch.schemes.fk"

SPANS = [
    {"module": _FK, "attr": "intt_fr", "tag": "ntt.fr_inverse"},
    {"module": _FK, "attr": "ntt_fr", "tag": "ntt.fr"},
    {"module": "verkle_kzg_tpu_torch.ops.curve", "attr": "projective_to_host_points", "tag": "curve.to_host"},
    {"module": "verkle_kzg_tpu_torch.poly.lagrange", "attr": "FrVector.to_ints", "tag": "poly.to_ints"},
]


def make_inputs(cfg: dict, wl: dict, seed: int) -> dict:
    rng = random.Random(seed)
    n = int(cfg["field_elements_per_blob"])
    secret = rng.randrange(n + 1, E.R)
    pool = [[rng.randrange(E.R) for _ in range(n)] for _ in range(int(wl["pool"]))]
    return {"secret": secret, "pool": pool}


def prepare(cfg: dict, wl: dict, inputs: dict, device: str) -> SimpleNamespace:
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import kzg_setup

    params = kzg_setup(int(cfg["field_elements_per_blob"]), secret=inputs["secret"], device=device)
    params.lagrange_affine
    pool = [FrVector.from_ints(vals, params.domain, device=device) for vals in inputs["pool"]]
    return SimpleNamespace(params=params, pool=pool)


def run(state: SimpleNamespace, i: int) -> tuple:
    from verkle_kzg_tpu_torch.schemes import fk

    return tuple((p.proof, p.y) for p in fk.prove_all_points(state.params, state.pool[i]))


def expected(cfg: dict, wl: dict, inputs: dict, truncate: bool = False) -> list:
    omegas = E.domain(int(cfg["field_elements_per_blob"]))
    return [tuple(ref.all_proofs(vals, inputs["secret"], omegas, truncate)) for vals in inputs["pool"]]
