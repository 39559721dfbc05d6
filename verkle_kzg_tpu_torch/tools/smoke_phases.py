"""Run phases of the ``chip_smoke.py`` of a checkout on the card: by
default 2, 4, 7 and 9 (the kernels against their plain versions, the 2^20
MSM with its stages, the config-5 MSM sweep and the lane-stream grid); a
third argument lists others, e.g. ``3,5,6`` (the IPA at 256, the verkle
tree, the multiproof; 6 runs 3 first for its data) or ``10`` (the mesh
paths, which run 3, 5, 6 and 8 first, unprinted where not listed, for
their data and the results they are held to), ``11`` (config 4 over
KZG at key_len 3 and 32), ``12`` (the re-commit's branches: writes into phase 5's tree
and phase 11's, which run first, unprinted where not listed), or
``c``: one verkle commit of phase 5's tree under cProfile, after an
unprofiled one, with its
top entries by cumulative time (:func:`cprofile_top`). With ``g`` among
them it also prints, for each staged step of the phases run (the
checkout's ``_stage``), the collections of Python's cyclic garbage
collector inside it, by generation, and their ms. It times a parent
commit beside a change on one card in one call:

    mkdir -p _archive/parent && git archive <parent> | tar -x -C _archive/parent
    python3 verkle_kzg_tpu_torch/tools/smoke_phases.py _archive/parent parent
    python3 chip_smoke.py

A plain script, not a module of the package: it puts the checkout's root
first on the path, so the checkout's own ``verkle_kzg_tpu_torch`` and
``chip_smoke.py`` run (and build their kernels into its own ``_build/``).
Prints one line a phase, the tag first, as ``chip_smoke.py`` prints it.
Needs a CUDA card.
"""

import json
import os
import sys
import time

#: Functions whose cProfile rows :func:`cprofile_top` adds to the top
#: entries: the host conversions of the verkle commit.
NAMED = ("projective_to_host_points", "affine_words", "words_to_ints", "ints_to_words", "g1_to_data_item",
         "<built-in method builtins.pow>", "_internal_vector", "_ext_leaf_dicts")


def cprofile_top(fn, top: int = 25) -> tuple:
    """``fn()`` under cProfile -> (its result, rows [function, calls, own
    s, cumulative s] of the ``top`` entries by cumulative time and of the
    :data:`NAMED` functions). cProfile adds a cost to every Python call,
    so the rows are shares to rank, not times."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    out = prof.runcall(fn)
    stats = pstats.Stats(prof).stats  # (file, line, name) -> (prim calls, calls, own s, cum s, callers)
    ranked = sorted(stats.items(), key=lambda kv: -kv[1][3])
    rows = [kv for i, kv in enumerate(ranked) if i < top or kv[0][2] in NAMED]
    return out, [[f"{os.path.basename(f)}:{line}({name})", v[1], round(v[2], 4), round(v[3], 4)]
                 for (f, line, name), v in rows]


def gc_by_stage(S):
    """Record the cyclic collector's collections and time them inside each
    call of the checkout's ``chip_smoke._stage`` -> a function giving
    {stage: {generation: [collections, ms]}}."""
    import gc

    events, spans, began = [], [], []

    def collected(phase, info):
        if phase == "start":
            began.append(time.perf_counter())
        else:
            events.append((info["generation"], began.pop(), time.perf_counter()))

    gc.callbacks.append(collected)
    inner = S._stage

    def staged(name, *args, **kwargs):
        t0 = time.perf_counter()
        out = inner(name, *args, **kwargs)
        spans.append((name, t0, time.perf_counter()))
        return out

    S._stage = staged

    def report():
        out = {}
        for name, t0, t1 in spans:
            row = out.setdefault(name, {})
            for g, a, b in events:
                if t0 <= a and b <= t1:
                    n, ms = row.get(g, [0, 0.0])
                    row[g] = [n + 1, round(ms + (b - a) * 1e3, 3)]
        return out

    return report


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    tag = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    phases = set((sys.argv[3] if len(sys.argv) > 3 else "2,4,7,9").split(","))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as S
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.schemes import IPA, ipa_setup

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = S.card_line()
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(tag, f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    crs = ipa_setup(256, device=dev)
    gc_report = gc_by_stage(S) if "g" in phases else None

    def run(phase, fn, show=json.dumps):
        if phase not in phases:
            return None
        t0 = time.perf_counter()
        cuda_lib.reset_launches()
        out = fn()
        print(tag, f"phase {phase} ({time.perf_counter() - t0:.1f} s):", show(out), f"[{card}]", flush=True)
        return out

    def launches(out):
        return "launches " + json.dumps(out["path_launches"])

    run("2", lambda: S.phase_kernels(dev, crs))
    ipa = run("3", lambda: S.phase_ipa(dev, crs), lambda out: json.dumps(out[0]))
    run("4", lambda: S.phase_msm(dev))
    committed = []  # phase 5's tree and phase 11's key_len-32 one, for phase 12
    keep = {"keep": committed} if "12" in phases else {}
    verkle = run("5", lambda: S.phase_verkle(dev, crs, **keep))
    mp = None
    if phases & {"6", "10"}:
        ipa_data = (ipa or S.phase_ipa(dev, crs))[1]
        mp = run("6", lambda: S.phase_multiproof(dev, crs, ipa_data))
    run("7", lambda: S.phase_sweep(dev, card), launches)
    kzg = run("8", lambda: S.phase_kzg(dev, card))
    run("9", lambda: S.phase_group(dev, card), launches)

    def commit_profile():
        inputs = S._verkle_inputs(10_000)
        S._verkle_build(IPA, crs, 32, *inputs).commitment()
        tree = S._verkle_build(IPA, crs, 32, *inputs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rows = cprofile_top(tree.commitment)
        return {"profiled_wall_ms": (time.perf_counter() - t0) * 1e3, "rows": rows}

    run("c", commit_profile)
    if "10" in phases:
        mp = mp or S.phase_multiproof(dev, crs, ipa_data)
        ref = {"root": (verkle or S.phase_verkle(dev, crs))["root"], "d": mp["d"],
               "mp_sha256": mp.get("digest"), "fk_sha256": (kzg or S.phase_kzg(dev, card))["fk_sha256"]}
        run("10", lambda: S.phase_mesh(dev, card, crs, ipa_data, ref), launches)
    if "12" in phases and verkle is None:
        S.phase_verkle(dev, crs, keep=committed)
    kzg_trees = run("11", lambda: S.phase_verkle_kzg(dev, card, **keep), lambda out: json.dumps(
        {k: r["ms"] for k, r in out.items() if k.startswith("key_len")}))
    if "12" in phases and kzg_trees is None:
        S.phase_verkle_kzg(dev, card, keep=committed)
    run("12", lambda: S.phase_writes(dev, card, committed), lambda out: json.dumps(
        {k: {"dirty": r["dirty"], "ms": r["ms"]} for k, r in out.items()}))
    if gc_report is not None:
        print(tag, "gc by stage:", json.dumps(gc_report()), f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
