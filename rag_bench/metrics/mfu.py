"""Model step: model FLOPs of the window's admissions and decode steps
(``harness/peaks.ModelFlops``: two per active parameter a token, plus
causal attention over each token's context; padded prompt tokens count, the
engine computes them and attends to them) over the host-clock time inside
those engine calls, as a share of 989 TFLOP/s (bf16, the H100 data sheet;
the card's power limit is printed beside every run)."""
from rag_bench.harness.peaks import BF16_FLOPS


def read(ctx):
    flops, secs = 0.0, 0.0
    for s, w in ctx.admissions():
        flops += ctx.flops.prefill(w)
        secs += s
    for s, contexts in ctx.decode_steps():
        flops += sum(ctx.flops.token(c) for c in contexts)
        secs += s
    return 100.0 * flops / (secs * BF16_FLOPS) if secs else None
