"""Engine: host-clock time of the window's admissions (prefill and slot
insert; each ends by reading its first token) per thousand padded prompt
tokens."""


def read(ctx):
    rows = ctx.admissions()
    tokens = sum(w for _, w in rows)
    return 1e6 * sum(s for s, _ in rows) / tokens if tokens else None
