"""The port (its parallel package and utilities among it), its chip smoke
script, its card tests and the mesh tests' rank program import nothing of the
JAX package (the port keeps its own copies of the host modules it needs),
no JAX (the card's machine has none) and no Triton at module level; and the
port's entry points run on the card unless told otherwise."""

import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]

_CODE = """
import importlib, pkgutil, sys
import verkle_kzg_tpu_torch as P
for m in pkgutil.walk_packages(P.__path__, P.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
import verkle_kzg_tpu_torch.parallel, verkle_kzg_tpu_torch.utils.persist, verkle_kzg_tpu_torch.utils.profiling
sys.path.insert(0, "tests")
import test_torch_kernels
import torch_mesh_ranks
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("verkle_kzg_tpu", "jax", "jaxlib", "triton"))
assert not bad, bad
print("clean")
"""


def test_port_imports_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _CODE], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, every entry point that is not told a device raises;
    with ``device="cpu"`` each runs the plain versions."""
    from verkle_kzg_tpu_torch.poly import Domain, FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, IPAParams, KZGParams, ipa_setup, kzg_generate_monomial_srs, kzg_setup
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ipa_setup(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrVector.from_ints([1, 2], Domain(4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FrVector.zero(Domain(4))
    crs = ipa_setup(4, device="cpu")
    assert crs.device == torch.device("cpu") and crs.g_affine.device == crs.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        IPAParams(n=4, g_host=crs.g_host, q_host=crs.q_host, domain=crs.domain)
    assert FrVector.from_ints([1, 2], crs.domain, device="cpu").device == crs.device
    assert VerkleTree(IPA, crs, key_len=3).device == crs.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kzg_setup(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kzg_generate_monomial_srs(4)
    kzg = kzg_setup(4, device="cpu")
    assert kzg.device == torch.device("cpu") and kzg.lagrange_affine.device == kzg.device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KZGParams(size=4, lagrange_host=kzg.lagrange_host, g2=kzg.g2, domain=kzg.domain)
