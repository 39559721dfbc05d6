"""The program's own spans (``verkle_kzg_tpu_torch/utils/metrics.span``),
read from ``run.counters``: the always-on counters of every op of the
traced run's window, which the harness resets when the window opens. Each
span adds ``span.<layer>.<site>.calls``, ``.s`` (inclusive seconds) and
``.self_s`` (the seconds less the spans opened inside it); a program
without spans has none of these keys, and the readers then read nothing."""

TOP = 5


def layer_self_ms(run, layer: str):
    """(ms an op of the layer's self time, a note naming its largest sites
    and its spans an op), or None where the run recorded no span of it."""
    prefix, suffix = f"span.{layer}.", ".self_s"
    sites = {k[len(prefix):-len(suffix)]: v for k, v in run.counters.items()
             if k.startswith(prefix) and k.endswith(suffix)}
    if not sites:
        return None
    calls = sum(run.counters.get(f"{prefix}{site}.calls", 0) for site in sites)
    top = sorted(sites.items(), key=lambda kv: -kv[1])[:TOP]
    per_op = 1e3 / run.n_ops
    note = (f"{calls / run.n_ops:.1f} spans an op over {run.n_ops} ops; largest self ms an op: "
            + ", ".join(f"{site} {v * per_op:.4f}" for site, v in top))
    return sum(sites.values()) * per_op, note
