"""Run phases of the ``chip_smoke.py`` of a checkout on the card: by
default 2, 4, 7 and 9 (the kernels against their plain versions, the 2^20
MSM with its stages, the config-5 MSM sweep and the lane-stream grid); a
third argument lists others, e.g. ``3,5,6`` (the IPA at 256, the verkle
tree, the multiproof; 6 runs 3 first for its data) or ``10`` (the mesh
paths, which run 3, 5, 6 and 8 first, unprinted where not listed, for
their data and the results they are held to). It times a parent
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


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
    tag = sys.argv[2] if len(sys.argv) > 2 else os.path.basename(root)
    phases = set((sys.argv[3] if len(sys.argv) > 3 else "2,4,7,9").split(","))
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as S
    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.schemes import ipa_setup

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = S.card_line()
    t0 = time.perf_counter()
    cuda_lib.lib()
    print(tag, f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    crs = ipa_setup(256, device=dev)

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
    verkle = run("5", lambda: S.phase_verkle(dev, crs))
    mp = None
    if phases & {"6", "10"}:
        ipa_data = (ipa or S.phase_ipa(dev, crs))[1]
        mp = run("6", lambda: S.phase_multiproof(dev, crs, ipa_data))
    run("7", lambda: S.phase_sweep(dev, card), launches)
    kzg = run("8", lambda: S.phase_kzg(dev, card))
    run("9", lambda: S.phase_group(dev, card), launches)
    if "10" in phases:
        mp = mp or S.phase_multiproof(dev, crs, ipa_data)
        ref = {"root": (verkle or S.phase_verkle(dev, crs))["root"], "d": mp["d"],
               "mp_sha256": mp.get("digest"), "fk_sha256": (kzg or S.phase_kzg(dev, card))["fk_sha256"]}
        run("10", lambda: S.phase_mesh(dev, card, crs, ipa_data, ref), launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
