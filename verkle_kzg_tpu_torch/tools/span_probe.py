"""The program's spans on the card: what one costs, and where the host
waits.

    python3 verkle_kzg_tpu_torch/tools/span_probe.py [--queries 1024] [--width 256] [--blob 4096]

Prints one JSON line each:

* ``cost``: the host's nanoseconds a span (``utils/metrics.span``) with no
  profiler running and under ``torch.profiler`` (CPU and CUDA activity),
  as a ``with`` block and as a decorated call, each the mean of many;
* ``op``, for a verkle multiproof over the IPA (``queries`` openings of one
  vector of ``width``, at uniform points) and for FK's all-point prove of
  one blob of ``blob`` elements: after a warm-up op, one op under
  ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising call
  with the innermost span open at it and the port's line that made it, the
  count outside a ``wait`` span, and the op's spans by layer.

Exits 1 when a synchronising call falls outside a ``wait`` span. A plain
script: it puts its checkout's root first on the path. Needs a CUDA card.
"""

import argparse
import collections
import json
import pathlib
import random
import sys
import time
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from verkle_kzg_tpu_torch.params import R  # noqa: E402
from verkle_kzg_tpu_torch.utils import metrics  # noqa: E402

PKG = str(ROOT / "verkle_kzg_tpu_torch")
SKIP = ("utils/metrics.py", "tools/span_probe.py")


def cost(n: int = 20000) -> dict:
    """ns a span: a ``with`` block and a decorated call, profiler off and on."""
    s = metrics.span("protocol", "probe.cost")
    fn = metrics.span("protocol", "probe.call")(lambda: None)

    def per_span(body) -> float:
        t0 = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t0) / n

    def with_block():
        for _ in range(n):
            with s:
                pass

    def decorated():
        for _ in range(n):
            fn()

    def noop():
        return None

    def bare():
        for _ in range(n):
            noop()

    out = {}
    for tag in ("off", "profiler"):
        prof = None
        if tag == "profiler":
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        with_block()  # warm
        out[tag] = {"with_ns": per_span(with_block), "decorated_ns": per_span(decorated) - per_span(bare)}
        if prof is not None:
            prof.__exit__(None, None, None)
    metrics.reset_counters()
    return out


def _site() -> str:
    """The innermost frame of the port (not this script nor the span) on the stack."""
    stack = traceback.extract_stack()[:-2]
    for fr in reversed(stack):
        if fr.filename.startswith(PKG) and not fr.filename.endswith(SKIP):
            return f"{pathlib.Path(fr.filename).relative_to(ROOT)}:{fr.lineno} {fr.name}"
    return "outside the port: " + " < ".join(f"{pathlib.Path(fr.filename).name}:{fr.lineno}" for fr in stack[::-1][:6])


def syncs(name: str, op) -> dict:
    """One warm-up op, then one op under the sync debug mode."""
    op()
    torch.cuda.synchronize()
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            seen.append((metrics.innermost(), _site(), f"{pathlib.Path(filename).name}:{lineno}"))

    metrics.reset_counters()
    torch.cuda.set_sync_debug_mode("warn")  # before the hook: the call warns of its own
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            op()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = collections.Counter(seen)
    outside = sum(k for (span, _, _), k in counts.items() if not (span or "").startswith("vk.wait."))
    spans = collections.Counter()
    for key, v in metrics.counters().items():
        if key.endswith(".calls"):
            spans[key.split(".")[1]] += v
    return {"op": name, "syncs": sum(counts.values()), "outside_wait": outside,
            "sites": [[span, site, caller, k] for (span, site, caller), k in sorted(counts.items(), key=str)],
            "spans_by_layer": dict(spans)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--queries", type=int, default=1024)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--blob", type=int, default=4096)
    args = p.parse_args(argv)

    from verkle_kzg_tpu_torch.ops import cuda_lib
    from verkle_kzg_tpu_torch.poly import FrVector
    from verkle_kzg_tpu_torch.schemes import IPA, ProverQuery, fk, ipa_setup, kzg_setup, prove_multiproof

    cuda_lib.lib()
    print(json.dumps({"cost": cost(), "card": torch.cuda.get_device_name(0)}), flush=True)

    rng = random.Random(args.queries * 7919 + args.blob)
    ipa = ipa_setup(args.width)
    vals = [rng.randrange(R) for _ in range(args.width)]
    fv = FrVector.from_ints(vals, ipa.domain)
    c = IPA.commit(ipa, fv)
    zs = [rng.randrange(args.width) for _ in range(args.queries)]
    queries = [ProverQuery(fv, c, z, vals[z]) for z in zs]
    kzg = kzg_setup(args.blob)
    kzg.lagrange_affine
    blob = FrVector.from_ints([rng.randrange(R) for _ in range(args.blob)], kzg.domain)

    bad = 0
    for name, op in (("multiproof", lambda: prove_multiproof(IPA, ipa, queries)),
                     ("fk", lambda: fk.prove_all_points(kzg, blob))):
        got = syncs(name, op)
        bad += got["outside_wait"]
        print(json.dumps(got), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
