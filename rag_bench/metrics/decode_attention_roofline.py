"""Kernels: ``decode_attention``'s share of its roofline in the traced
sub-window: the bytes its launches must move (each slot's K and V rows up to
its length, on a ring-window layer at most its window; queries, output;
``harness/peaks``), summed over the layers, at 3.35 TB/s, over the
profiler's device time of those launches.  Nothing to read where the model
launches none (MLA) or the trace's launches do not match the steps seen."""
from rag_bench.harness.peaks import HBM_BYTES_PER_S, decode_attention_bytes


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.step_lens:
        return None
    n, secs = t["kernels"]["decode_attention"]
    if not n or n != len(ctx.attn_windows) * len(ctx.step_lens) or secs <= 0:
        return None
    kv, dh, h, b = ctx.attn_shape
    total = sum(decode_attention_bytes(lens, kv, dh, h, b, window=w)
                for lens in ctx.step_lens for w in ctx.attn_windows)
    return 100.0 * total / HBM_BYTES_PER_S / secs
