"""What decides ``correct``: the timed path's own outputs against the plain
reference (``reference/``), once the window has closed.

Three layers, a number each (or two), each held to a limit of its cell
(``cells/<cell>.json``):

* ``gen_gap`` — generation.  A sample, drawn from the seed, of the engine
  sequences that were admitted in the window and finished, the longest
  among them, some hundreds of served tokens in all.  The reference runs
  once over each sequence's left-padded row (as the engine admitted it,
  pads attended) followed by its served tokens, and reads the logits where
  each served token was chosen: the first from the admission's prefill,
  the rest from decode steps through the cache.  The number is the widest
  gap by which a served token's logit lies below the reference's best, in
  units of the spread (standard deviation over the vocabulary) of the
  reference's logits at that position, so that it reads alike at every
  width; ``gen_gap_logits`` is the same gap in logits, for the record.
  ``gen_gap_mean`` is the mean of the gaps over the served tokens and
  ``gen_miss`` the share of served tokens that are not the reference's
  best: steadier numbers than the widest gap where routing among experts
  flips on rounding (a cell's limits say which are compared).
* ``ret_dist_err`` and ``ret_rank_err`` — retrieval, at two stages.  A
  sample, drawn from the seed, of the (query, cluster) items of the window's
  retrieval sub-stages, half served by the device path (``ivf_scan`` over
  the hot clusters) and half by the host path where both occur: the
  reference scans the cluster's members exactly, in float64, from the
  benchmark's own corpus.  And a sample of the request groups of those
  sub-stages, each with the top-k that the program's scheduler merged from
  the group's running top-k and its items: the reference scans the union
  of the group's probed clusters exactly and merges it with the running
  top-k the group started from (the program's state, its distances as
  held).  ``ret_dist_err``: the widest gap between a distance the program
  reported and the true distance of the doc it named; ``ret_rank_err``: the
  widest excess of the true distance of the program's r-th answer over the
  exact r-th (a doc missed, a wrong one named, or the answer out of order).  A wrong id, a missing answer or a
  repeated doc reads infinity.
* ``ret_query`` — the queries: the sampled groups whose query differs, bit
  for bit, from the one the benchmark's own embedder computes again for the
  request and round (limit 0).
* ``unfinished`` — completion: requests due in the window that did not
  finish all their stages by the end of the drain (limit 0).

The control (``control_numbers``) puts the reference one precision step
down in the program's place and is judged by the same limits: it has to
come out not correct.

The cluster partition is the program's state: the reference reads which
docs make up a cluster from it and checks on its own that it is a
partition of the corpus (``partition``: 0 problems, limit 0).
"""
from __future__ import annotations

import importlib

import numpy as np

from . import traffic as tr

GEN_TOKENS_TARGET, GEN_SEQS_MIN, GEN_SEQS_MAX = 600, 4, 12
RET_ITEMS, RET_GROUPS = 256, 64


def gen_sample(records, t0: float, seed: int) -> list:
    """Finished sequences admitted in the window: the longest, then others
    drawn from the seed until some hundreds of served tokens (at least
    four sequences, at most twelve)."""
    done = [r for r in records if r.t_admit >= t0 and r.seq.done]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.seq.tokens), r.seq.seq_id))
    out, rest = [done[0]], done[1:]
    order = tr.rng(seed, 4).permutation(len(rest))
    n = len(done[0].seq.tokens)
    for i in order:
        if (n >= GEN_TOKENS_TARGET and len(out) >= GEN_SEQS_MIN) or len(out) >= GEN_SEQS_MAX:
            break
        out.append(rest[i])
        n += len(rest[i].seq.tokens)
    return out


def row_problems(rec) -> list:
    """The admitted row must be the prompt, left-padded with zeros."""
    n = len(rec.prompt)
    row = rec.row
    pad = len(row) - n
    if pad < 0 or not np.array_equal(row[pad:], rec.prompt) or row[:pad].any():
        return [f"sequence {rec.seq.seq_id}: the admitted row is not its prompt left-padded"]
    return []


def gen_numbers(torch, dev, params, cfg_view: dict, sample, controls=()) -> dict:
    """{"gen_gap": widest gap in logit spreads, "gen_gap_mean": their mean,
    "gen_miss": the share of tokens with a gap, "gen_gap_logits": the widest
    in logits, "gen_tokens": tokens compared; and for each precision ``p``
    in ``controls`` the same three with the suffix ``.p``, of the token that
    precision puts first at each position}."""
    from rag_bench.reference.common import Precision, no_tf32

    ref = importlib.import_module(f"rag_bench.reference.{cfg_view['model_type']}")
    no_tf32()
    worst = {p: 0.0 for p in ("program",) + tuple(controls)}
    total, missed = dict.fromkeys(worst, 0.0), dict.fromkeys(worst, 0)
    n_tok, raw = 0, 0.0
    for rec in sample:
        served = np.asarray(rec.seq.tokens, np.int64)
        width = len(rec.row)
        seq = np.concatenate([rec.row, served[:-1]])
        toks = torch.as_tensor(seq, device=dev)
        at = torch.arange(width - 1, width - 1 + len(served), device=dev)
        with torch.no_grad():
            lg = ref.logits_at(params, cfg_view, toks, at, Precision("f32"))
            best = lg.max(-1).values
            sd = lg.std(-1)
            got = lg.gather(1, torch.as_tensor(served, device=dev)[:, None])[:, 0]
            gaps = {"program": (best - got) / sd}
            raw = max(raw, float((best - got).max()))
            for p in controls:
                top = ref.logits_at(params, cfg_view, toks, at, Precision(p)).argmax(-1)
                gaps[p] = (best - lg.gather(1, top[:, None])[:, 0]) / sd
            for p, g in gaps.items():
                worst[p] = max(worst[p], float(g.max()))
                total[p] += float(g.sum())
                missed[p] += int((g > 0).sum())
        n_tok += len(served)
    out = {"gen_gap_logits": raw, "gen_tokens": n_tok}
    for p in worst:
        sfx = "" if p == "program" else f".{p}"
        out[f"gen_gap{sfx}"] = worst[p]
        out[f"gen_gap_mean{sfx}"] = total[p] / max(n_tok, 1)
        out[f"gen_miss{sfx}"] = missed[p] / max(n_tok, 1)
    return out


def ret_sample(ret_rows, t0: float, seed: int) -> list:
    """(query, cluster, ids, dists, k, on_device) items of the window's
    sub-stages: up to RET_ITEMS, half device-path and half host-path where
    both occur, drawn from the seed."""
    dev_items, host_items = [], []
    for row in ret_rows:
        if row.t < t0:
            continue
        plan = row.plan
        for i in range(plan.n_items):
            c = int(plan.cluster_ids[i])
            (dev_items if row.resident[c] else host_items).append((plan, row.items, i, c))
    r = tr.rng(seed, 5)
    half = RET_ITEMS // 2
    pick = []
    for items, n in ((dev_items, half + max(0, half - len(host_items))),
                     (host_items, half + max(0, half - len(dev_items)))):
        for j in r.permutation(len(items))[:n]:
            plan, res, i, c = items[j]
            pick.append((plan.queries[i], c, res.ids[i], res.dists[i], plan.k, items is dev_items))
    return pick


def group_sample(ret_rows, t0: float, seed: int) -> list:
    """Request groups of the window's sub-stages whose merge the scheduler
    made: up to RET_GROUPS, drawn from the seed.  Each is a dict of the
    request and round, the query the program held, the probed clusters, the
    running top-k it started from, and the merged top-k."""
    groups = []
    for row in ret_rows:
        if row.t < t0 or "res" not in row.merged:
            continue
        plan, res = row.plan, row.merged["res"]
        for g, rid, rnd in row.groups:
            lo, hi = int(plan.group_start[g]), int(plan.group_start[g + 1])
            if hi == lo:
                continue
            k = int(plan.group_k[g])
            groups.append(dict(rid=rid, round=rnd, queries=plan.queries[lo:hi],
                               clusters=plan.cluster_ids[lo:hi], k=k,
                               seed_ids=plan.seed_ids[g], seed_d=plan.seed_dists[g],
                               ids=res.ids[g, :k], dists=res.dists[g, :k]))
    order = tr.rng(seed, 8).permutation(len(groups))[:RET_GROUPS]
    return [groups[j] for j in order]


def query_problems(groups, embedder) -> int:
    """Groups whose every item does not carry, bit for bit, the query the
    embedder computes for the group's request and round."""
    bad = 0
    for grp in groups:
        want = embedder.embed_query(grp["rid"], grp["round"])
        bad += not all(np.array_equal(q, want) for q in grp["queries"])
    return bad


def _judge_answer(q, got_ids, got_d, allowed: dict, want_d) -> tuple[float, float]:
    """(distance error, rank error) of a top-k answer ``got`` against the
    exact ``want_d``; ``allowed`` maps each doc that may be named to its
    true distance.  A doc not allowed, repeated, or an answer short of
    ``want_d`` reads infinity."""
    kk = len(want_d)
    got_ids, got_d = np.asarray(got_ids)[:kk], np.asarray(got_d)[:kk]
    if (len(got_ids) < kk or any(int(g) not in allowed for g in got_ids)
            or len(set(got_ids.tolist())) < kk):
        return float("inf"), float("inf")
    true = np.asarray([allowed[int(g)] for g in got_ids], np.float64)
    # in the answer's own order: its r-th doc has to be the r-th nearest
    return (float(np.abs(got_d.astype(np.float64) - true).max(initial=0.0)),
            float((true - want_d).max(initial=0.0)))


def ret_numbers(items, ids: np.ndarray, offsets: np.ndarray, docs: np.ndarray,
                answer=None, groups=(), embedder=None) -> dict:
    """``ret_dist_err`` and ``ret_rank_err`` of the program's answers (or of
    ``answer(query, members, vectors, k)``'s, the control's, merged as the
    program merges) against the exact scan: over the sampled ``items`` and
    the sampled request ``groups``; and the items on each path."""
    from rag_bench.reference.ivf import scan_topk, true_dists

    dist_err = rank_err = 0.0
    n_dev = n_host = 0
    for q, c, got_ids, got_d, k, on_dev in items:
        members = ids[offsets[c]: offsets[c + 1]]
        vecs = docs[members]
        kk = min(int(k), len(members))
        want_ids, want_d = scan_topk(q, members, vecs, kk)
        if answer is not None:
            got_ids, got_d = answer(q, members, vecs, kk)
        n_dev += on_dev
        n_host += not on_dev
        allowed = dict(zip(members.tolist(), true_dists(q, vecs).tolist()))
        d, r = _judge_answer(q, got_ids, got_d, allowed, want_d)
        dist_err, rank_err = max(dist_err, d), max(rank_err, r)
    for grp in groups:
        q = embedder.embed_query(grp["rid"], grp["round"])
        members = np.unique(np.concatenate([ids[offsets[c]: offsets[c + 1]]
                                            for c in grp["clusters"]]))
        vecs = docs[members]
        held = grp["seed_ids"] >= 0
        s_ids, s_d = grp["seed_ids"][held], grp["seed_d"][held].astype(np.float64)
        kk = min(grp["k"], len(members) + len(s_ids))
        _, scan_d = scan_topk(q, members, vecs, kk)
        want_d = np.sort(np.concatenate([s_d, scan_d]))[:kk]
        allowed = dict(zip(members.tolist(), true_dists(q, vecs).tolist()))
        allowed.update(zip(s_ids.tolist(), s_d.tolist()))  # the running top-k as held
        if answer is None:
            got_ids, got_d = grp["ids"], grp["dists"]
        else:  # the control's scan, merged with the running top-k by its distances
            c_ids, c_d = answer(q, members, vecs, kk)
            all_ids = np.concatenate([s_ids, c_ids])
            all_d = np.concatenate([s_d, np.asarray(c_d, np.float64)])
            top = np.argsort(all_d, kind="stable")[:kk]
            got_ids, got_d = all_ids[top], all_d[top]
        d, r = _judge_answer(q, got_ids, got_d, allowed, want_d)
        dist_err, rank_err = max(dist_err, d), max(rank_err, r)
    return {"ret_dist_err": dist_err, "ret_rank_err": rank_err,
            "ret_device_items": n_dev, "ret_host_items": n_host, "ret_groups": len(groups)}


def control_numbers(numbers: dict, gen: str = "fp8", ret: str = "bf16") -> dict:
    """``numbers`` with the control in the program's place: the generation
    numbers read for precision ``gen`` (``gen_gap.fp8`` as ``gen_gap``), the
    retrieval numbers for ``ret``; completion, the partition and the queries
    stay the program's, which no precision changes."""
    out = dict(numbers)
    for key, v in numbers.items():
        base, _, p = key.rpartition(".")
        if (base.startswith("gen_") and p == gen) or (base.startswith("ret_") and p == ret):
            out[base] = v
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and {name: {"value", "limit"}} of every number compared."""
    shown, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        shown[name] = {"value": v, "limit": limit}
        if v is None or not v <= limit:
            ok = False
    return ok, shown
