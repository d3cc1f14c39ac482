"""Engine: mean host-clock time of a ``GenerationEngine.step`` that held
sequences (a replay of the captured decode graph; it ends by reading the
tokens back, which waits for the card), over the window."""


def read(ctx):
    d = ctx.durations("decode")
    return 1e3 * sum(d) / len(d) if d else None
