"""Ranks of a gloo process group for the port's mesh tests (not collected:
the name does not start with ``test_``).

    python tests/torch_mesh_ranks.py TASKS STORE RANK WORLD WORKDIR

Each rank joins a gloo group of WORLD ranks on the CPU through the file
store STORE (no TCP port, so parallel test workers cannot collide), builds
``make_mesh(device="cpu")``, runs each comma-separated task of TASKS on the
inputs in WORKDIR/inputs.npz and WORKDIR/inputs.json, and writes its
results to WORKDIR/rank{RANK}.npz (tensors) and WORKDIR/rank{RANK}.json
(host values). A collective waits at most 60 s. It imports torch, numpy
and the port only, and a rank fails if anything imported JAX or the JAX
package.

The tests start a group with :func:`run_ranks`, which kills every rank of
the group as soon as one fails or when the group outlives its timeout, so a
hung collective fails its test and never holds the suite.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(tasks: str, world: int, workdir, inputs: dict, config: dict | None = None,
              timeout: float = 240.0) -> list:
    """Run ``tasks`` on ``world`` gloo ranks over ``inputs`` (name -> numpy
    array) and ``config`` (JSON); return each rank's (arrays, values)."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inputs)
    (workdir / "inputs.json").write_text(json.dumps(config or {}))
    store = workdir / "store"
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, tasks, str(store), str(r), str(world), str(workdir)],
            cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT,
        )
        for r in range(world)
    ]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tail = (workdir / f"rank{failed[0]}.log").read_text()[-3000:]
        raise AssertionError(f"{tasks} on {world} ranks: ranks {failed} failed or timed out\n{tail}")
    out = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        out.append((arrays, json.loads((workdir / f"rank{r}.json").read_text())))
    return out


def start_groups(groups: dict, root, inputs: dict, config: dict | None = None) -> dict:
    """Start one group of ranks for each ``world -> tasks`` of ``groups``, all
    at once, under ``root``; return world -> a future of :func:`run_ranks`'s
    result. The caller can compute its references while the ranks run."""
    pool = concurrent.futures.ThreadPoolExecutor(len(groups))
    futures = {w: pool.submit(run_ranks, tasks, w, pathlib.Path(root) / f"d{w}", inputs, config)
               for w, tasks in groups.items()}
    pool.shutdown(wait=False)
    return futures


def replicated(results: list, key: str) -> np.ndarray:
    """The array ``key`` of rank 0, after checking that every rank holds it."""
    first = results[0][0][key]
    for arrays, _ in results[1:]:
        assert np.array_equal(arrays[key], first), key
    return first


def seeded_scalars(rng, n: int) -> list:
    """n scalars in [0, R) from numpy's generator ``rng``."""
    from verkle_kzg_tpu_torch.params import R

    words = rng.integers(0, 1 << 63, size=(n, 5), dtype=np.int64)
    return [sum(int(w) << (63 * i) for i, w in enumerate(row)) % R for row in words]


def seeded_basis(rng, n: int) -> list:
    """n distinct host points a + i b, a and b seeded multiples of G."""
    from verkle_kzg_tpu_torch.hostmath.curve import g1_add, g1_generator, g1_mul

    a, b = (g1_mul(g1_generator(), k) for k in seeded_scalars(rng, 2))
    pts = [a]
    for _ in range(n - 1):
        pts.append(g1_add(pts[-1], b))
    return pts


# -- the rank side ------------------------------------------------------------


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def task_fr(mesh, arrays, config, out, vals):
    """Fr four-step, forward and inverse, for each (name, n1) in config["fr"]."""
    from verkle_kzg_tpu_torch.parallel import ntt as P

    for name, n1 in config["fr"]:
        x = _t(arrays[name])
        out[f"{name}.ntt"] = P.ntt_fr_sharded(x, mesh, n1)
        out[f"{name}.intt"] = P.intt_fr_sharded(x, mesh, n1)
        vals[f"{name}.roundtrip"] = bool((P.intt_fr_sharded(out[f"{name}.ntt"], mesh, n1) == x).all())


def task_g1(mesh, arrays, config, out, vals):
    """G1 four-step, forward and inverse, for each (name, n1) in config["g1"]."""
    from verkle_kzg_tpu_torch.parallel import ntt as P

    for name, n1 in config["g1"]:
        x = _t(arrays[name])
        out[f"{name}.ntt"] = P.ntt_g1_sharded(x, mesh, n1)
        out[f"{name}.intt"] = P.intt_g1_sharded(x, mesh, n1)


def task_msm(mesh, arrays, config, out, vals):
    """The three sharded MSMs on every case named in config["msm"]."""
    from verkle_kzg_tpu_torch.parallel import mesh as PM

    for kind, name in config["msm"]:
        fn = {"single": PM.msm_sharded, "batched": PM.msm_batched_sharded,
              "fixed": PM.msm_fixed_base_sharded}[kind]
        out[name] = fn(_t(arrays[f"{name}.points"]), _t(arrays[f"{name}.scalars"]), mesh)


def task_protocols(mesh, arrays, config, out, vals):
    """The mesh= paths over the IPA at config["n"]: a tree of config["keys"],
    a commit, and one multiproof's D and verify."""
    from verkle_kzg_tpu_torch.params import R
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, ProverQuery, ipa_setup, prove_multiproof, verify_multiproof
    from verkle_kzg_tpu_torch.verkle import VerkleTree

    crs = ipa_setup(config["n"], device="cpu")
    tree = VerkleTree(IPA, crs, key_len=3, internal_width=config["n"], mesh=mesh)
    for i, k in enumerate(config["keys"]):
        tree.insert_single(tuple(k), 1000 + i)
    vals["tree_root"] = tree.commitment()
    data = FrVector.from_ints(config["data"], crs.domain, device="cpu")
    commit = IPA.commit(crs, data, mesh=mesh)
    vals["commit"] = commit
    queries = [ProverQuery(data=data, commit=commit, z=z, y=config["data"][z]) for z in config["zs"]]
    proof = prove_multiproof(IPA, crs, queries, mesh=mesh)
    vals["multiproof_d"] = proof.d
    vq = [q.to_verifier_query() for q in queries]
    vals["verify"] = verify_multiproof(IPA, crs, vq, proof, mesh=mesh)
    vq[0].y = (vq[0].y + 1) % R
    vals["verify_wrong_y"] = verify_multiproof(IPA, crs, vq, proof, mesh=mesh)


def task_fk(mesh, arrays, config, out, vals):
    """FK all-points proofs at config["fk_n"] over config["fk_data"], with the mesh."""
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import kzg_setup
    from verkle_kzg_tpu_torch.schemes.fk import prove_all_points

    crs = kzg_setup(config["fk_n"], device="cpu")
    data = FrVector.from_ints(config["fk_data"], crs.domain, device="cpu")
    vals["fk"] = [(p.proof, p.y) for p in prove_all_points(crs, data, mesh=mesh)]


def task_mesh(mesh, arrays, config, out, vals):
    """What make_mesh refuses on a gloo group, and a mesh over rank 0 alone."""
    import torch

    from verkle_kzg_tpu_torch.parallel import make_mesh, msm_sharded

    try:
        make_mesh(device="cuda:0")
        vals["cuda_on_gloo"] = "accepted"
    except ValueError as e:
        vals["cuda_on_gloo"] = str(e)
    try:
        make_mesh()  # the card by default: this box has none
        vals["default"] = "accepted"
    except RuntimeError as e:
        vals["default"] = str(e)
    try:
        make_mesh(mesh.size + 1, device="cpu")
        vals["too_many"] = "accepted"
    except ValueError as e:
        vals["too_many"] = str(e)
    one = make_mesh(1, device="cpu")  # every rank calls new_group
    vals["one"] = [one.size, one.rank]
    try:
        msm_sharded(torch.zeros((4, 2, 8), dtype=torch.int32, device="meta"),
                    torch.zeros((4, 8), dtype=torch.int32), mesh)
        vals["wrong_device"] = "accepted"
    except ValueError as e:
        vals["wrong_device"] = str(e)


TASKS = {"fr": task_fr, "g1": task_g1, "msm": task_msm, "protocols": task_protocols, "fk": task_fk,
         "mesh": task_mesh}


def main(argv) -> int:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    from verkle_kzg_tpu_torch.parallel import make_mesh

    tasks, store, rank, world, workdir = argv[1], argv[2], int(argv[3]), int(argv[4]), pathlib.Path(argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_mesh(device="cpu")
        with np.load(workdir / "inputs.npz") as z:
            arrays = {k: z[k] for k in z.files}
        config = json.loads((workdir / "inputs.json").read_text())
        out, vals = {}, {}
        for task in tasks.split(","):
            t0 = time.perf_counter()
            TASKS[task](mesh, arrays, config, out, vals)
            vals[f"{task}.seconds"] = time.perf_counter() - t0
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("verkle_kzg_tpu", "jax", "jaxlib"))
        if bad:
            raise RuntimeError(f"a rank imported the JAX package or JAX: {bad}")
        np.savez(workdir / f"rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})
        (workdir / f"rank{rank}.json").write_text(json.dumps(vals))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
