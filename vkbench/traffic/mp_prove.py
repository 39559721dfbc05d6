"""Op kind ``mp_prove``: one verkle multiproof over the IPA.

The op is ``schemes.multiproof.prove_multiproof(IPA, params, queries)``
over ``queries`` openings, at uniform seeded points of the domain, of one
seeded vector of the configuration's width, against that vector's
commitment. Each input of the pool has its own vector. The answer is the
multiproof's D and the IPA proof's L and R points, final scalar and y.
"""

from __future__ import annotations

import random
from types import SimpleNamespace

from vkbench.reference import bn254 as E
from vkbench.reference import ipa as ref

_MP = "verkle_kzg_tpu_torch.schemes.multiproof"
_IPA = "verkle_kzg_tpu_torch.schemes.ipa"

#: The traced run's host spans around the calls into each layer.
SPANS = [
    {"module": _MP, "attr": "_absorb_queries", "tag": "transcript.absorb"},
    {"module": _MP, "attr": "_scale_and_group", "tag": "multiproof.group"},
    {"module": _MP, "attr": "_quotients_sum", "tag": "multiproof.quotients"},
    {"module": _MP, "attr": "fr_batch_inverse", "tag": "multiproof.inverses"},
    {"module": _MP, "attr": "_h_accumulate", "tag": "multiproof.h"},
    {"module": _IPA, "attr": "IPA.commit", "tag": "ipa.commit"},
    {"module": _IPA, "attr": "IPA.prove_point", "tag": "ipa.prove"},
    {"module": _IPA, "attr": "_device_rounds", "tag": "ipa.rounds"},
    {"module": _IPA, "attr": "_read_back", "tag": "ipa.read_back"},
    {"module": _IPA, "attr": "_unpack_fused", "tag": "ipa.unpack"},
    {"module": "verkle_kzg_tpu_torch.ops.curve", "attr": "projective_to_host_points", "tag": "curve.to_host"},
]


def make_inputs(cfg: dict, wl: dict, seed: int) -> dict:
    """Per input of the pool: a vector of ``width`` elements of Fr and
    ``queries`` points drawn uniformly from the domain's indices."""
    rng = random.Random(seed)
    n, m = int(cfg["width"]), int(wl["queries"])
    pool = []
    for _ in range(int(wl["pool"])):
        vals = [rng.randrange(E.R) for _ in range(n)]
        pool.append({"vals": vals, "zs": [rng.randrange(n) for _ in range(m)]})
    return {"pool": pool}


def prepare(cfg: dict, wl: dict, inputs: dict, device: str) -> SimpleNamespace:
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, ProverQuery, ipa_setup

    params = ipa_setup(int(cfg["width"]), seed=cfg["basis_seed"].encode(), device=device)
    pool = []
    for item in inputs["pool"]:
        fv = FrVector.from_ints(item["vals"], params.domain, device=device)
        c = IPA.commit(params, fv)
        pool.append([ProverQuery(fv, c, z, item["vals"][z]) for z in item["zs"]])
    return SimpleNamespace(params=params, pool=pool)


def run(state: SimpleNamespace, i: int) -> tuple:
    from verkle_kzg_tpu_torch.schemes import IPA, prove_multiproof

    mp = prove_multiproof(IPA, state.params, state.pool[i])
    p = mp.proof
    return mp.d, tuple(p.l), tuple(p.r), p.tip, p.y


def expected(cfg: dict, wl: dict, inputs: dict, truncate: bool = False) -> list:
    """The reference's answer to each input of the pool."""
    n = int(cfg["width"])
    g, q = ref.basis(n, cfg["basis_seed"].encode())
    omegas = E.domain(n)
    out = []
    for item in inputs["pool"]:
        vals = item["vals"]
        c = ref.commit(g, vals, truncate)
        d, (ls, rs, tip, y) = ref.multiproof(g, q, [(vals, c, z, vals[z]) for z in item["zs"]], omegas, truncate)
        out.append((d, tuple(ls), tuple(rs), tip, y))
    return out
