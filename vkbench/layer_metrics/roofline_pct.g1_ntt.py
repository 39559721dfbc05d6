"""The G1 transforms' share of their roofline: the least time one H100
needs for the G1 NTTs and inverse NTTs and the pointwise G1 scalar
multiplications of the window's ops (``work.py``), over their device time
by CUDA events recorded on the stream around each call of
``schemes.fk``'s ``ntt_g1``, ``intt_g1`` and ``C.scalar_mul`` (whose scalars are kept by
reference and counted once the window has closed)."""

from vkbench import work

_FK = "verkle_kzg_tpu_torch.schemes.fk"

PROBES = [
    {"module": _FK, "attr": "ntt_g1", "tag": "g1_ntt", "events": True,
     "keep": lambda pts: (pts.shape[0], False)},
    {"module": _FK, "attr": "intt_g1", "tag": "g1_intt", "events": True,
     "keep": lambda pts: (pts.shape[0], True)},
    {"module": _FK, "attr": "C.scalar_mul", "tag": "g1_smul", "events": True,
     "keep": lambda pts, scalars: scalars},
]


def read(run):
    calls = [c for t in ("g1_ntt", "g1_intt", "g1_smul") for c in (run.probes.by_tag(t) if run.probes else [])]
    if not calls or any(c.ms is None for c in calls):
        return None
    least, by = 0.0, set()
    for c in calls:
        if c.tag == "g1_smul":
            _, dbl, add = work.scalar_word_steps(c.kept)
            s, b = work.least_seconds(work.scalar_mul_fmuls(int(dbl), int(add)), work.scalar_mul_bytes(c.kept.shape[0]))
        else:
            n, inverse = c.kept
            s, b = work.least_seconds(work.g1_ntt_fmuls(n, inverse), work.g1_ntt_bytes(n))
        least += s
        by.add(b)
    device_s = sum(c.ms for c in calls) / 1e3
    share = work.share_pct(least, device_s)
    return share, f"{len(calls)} calls, least {least:.6f} s (bound by {', '.join(sorted(by))}) of {device_s:.6f} s"
