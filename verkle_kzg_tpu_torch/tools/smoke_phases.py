"""Run phases 2, 4, 7 and 9 of the ``chip_smoke.py`` of a checkout on the
card: the kernels against their plain versions, the 2^20 MSM with its
stages, the config-5 MSM sweep and the lane-stream grid. It times a parent
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
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    kern = S.phase_kernels(dev, crs)
    print(tag, f"phase 2 ({time.perf_counter() - t0:.1f} s):", json.dumps(kern), f"[{card}]", flush=True)
    t0 = time.perf_counter()
    msm = S.phase_msm(dev)
    print(tag, f"phase 4 ({time.perf_counter() - t0:.1f} s):", json.dumps(msm), f"[{card}]", flush=True)
    t0 = time.perf_counter()
    sweep = S.phase_sweep(dev, card)
    print(tag, f"phase 7 ({time.perf_counter() - t0:.1f} s): launches", json.dumps(sweep["path_launches"]),
          f"[{card}]", flush=True)
    t0 = time.perf_counter()
    group = S.phase_group(dev, card)
    print(tag, f"phase 9 ({time.perf_counter() - t0:.1f} s): launches", json.dumps(group["path_launches"]),
          f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
