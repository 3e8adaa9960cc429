"""The output check: the window's served tokens against the reference.

Once the window has closed and the program's state is freed, a sample
of the requests the run finished (status OK), drawn from the seed and
with the longest answer in it, is run through the plain reference
(``bench/references/<name>.py``, float32) over each prompt and its
served tokens.  At each served token the reference's best logit is
compared with its logit of the served token: ``max_logit_gap`` is the
widest such gap over the sample, ``mean_logit_gap`` their mean over all
the sample's served tokens.  Greedy serving puts first the token
its own arithmetic ranks first, so a sound program lies below the
reference's best only where two tokens nearly tie; a token altered,
dropped state or a lower precision lie further below.

:func:`control_gaps` is the control: the reference computed in float8
(``quant="fp8"``) in the program's place, read at each position by the
gap of the token it puts first.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

ROWS = 32768        # sequence rows a batch of the reference takes


def pick(results, n: int, seed: int) -> List[int]:
    """Indices of ``n`` finished requests: the one with the most served
    tokens, then others drawn from the seed."""
    done = [i for i, r in enumerate(results)
            if r.status == "OK" and len(r.tokens) > 0]
    if not done:
        return []
    longest = max(done, key=lambda i: (len(results[i].tokens), -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed % 2**64, 23])
    k = min(n - 1, len(rest))
    return [longest] + sorted(rng.choice(rest, k, replace=False).tolist())


def _inputs(c, wl, gen, results, idx, dev):
    """Each sampled request's sequence (prompt and served tokens but the
    last), the row of its first served token's logits, and its FFN
    groups: the engine's prefill chunks."""
    C, page = wl["engine"]["prefill_chunk"], wl["engine"]["page"]
    seqs, score_from, groups, served = [], [], [], []
    for i in idx:
        prompt, toks = gen[i].prompt, results[i].tokens
        cached = results[i].prefix_blocks * page
        if cached and "num_experts" in c:
            raise NotImplementedError(
                "an MoE request with a cached prefix: the chunks that "
                "computed its cached rows are another request's")
        s = len(prompt)
        seqs.append(torch.from_numpy(
            np.concatenate([prompt, toks[:-1]]).astype(np.int64)).to(dev))
        score_from.append(s - 1)
        groups.append([(a, min(a + C, s), C) for a in range(cached, s, C)])
        served.append(torch.from_numpy(toks.astype(np.int64)).to(dev))
    return seqs, score_from, groups, served


def _gap(ref: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """Per row: the reference's best logit minus its logit of ``chosen``."""
    return ref.max(-1).values - ref.gather(1, chosen[:, None])[:, 0]


def served_gaps(reg, c, wl, weights, gen, results, seed, dev) -> dict:
    """``max_logit_gap`` and ``tokens_compared`` of the sample, with each
    request's own widest gap."""
    t0 = time.perf_counter()
    idx = pick(results, wl["check"]["requests"], seed)
    if not idx:
        return {"max_logit_gap": float("inf"),
                "mean_logit_gap": float("inf"), "tokens_compared": 0,
                "requests": [], "seconds": 0.0}
    gaps = _gaps(reg, c, wl, weights, gen, results, idx, dev, None)
    out = _summary(gaps)
    out["requests"] = [{"index": i, "prompt": len(gen[i].prompt),
                        "tokens": len(results[i].tokens),
                        "gap": float(g.max())} for i, g in zip(idx, gaps)]
    out["seconds"] = time.perf_counter() - t0
    return out


def _summary(gaps: List[torch.Tensor]) -> dict:
    """The compared numbers of a sample's per-token gaps: the widest and
    the mean."""
    g = torch.cat(gaps).double()
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "tokens_compared": int(g.numel())}


def control_gaps(reg, c, wl, weights, gen, results, seed, dev) -> dict:
    """The same sample, read as the control: at each position the float8
    reference's first token, and the float32 reference's gap to it."""
    idx = pick(results, wl["check"]["requests"], seed)
    return _summary(_gaps(reg, c, wl, weights, gen, results, idx, dev,
                          "fp8"))


def _gaps(reg, c, wl, weights, gen, results, idx, dev, control):
    """Per sampled request, each served token's gap: to the served token
    or, for the ``control`` precision, to the token the reference in that
    precision puts first.  The requests go through the reference in
    batches of at most ``ROWS`` rows."""
    ref = reg.reference(c["reference"])
    out = []
    for batch in _batches(gen, results, idx):
        seqs, score_from, groups, served = _inputs(c, wl, gen, results,
                                                   batch, dev)
        exact = ref.logits(c, weights, seqs, score_from, groups)
        if control is None:
            out += [_gap(e, tok) for e, tok in zip(exact, served)]
        else:
            low = ref.logits(c, weights, seqs, score_from, groups,
                             quant=control)
            out += [_gap(e, lo.argmax(-1)) for e, lo in zip(exact, low)]
        del exact
    return out


def _batches(gen, results, idx):
    batch, rows = [], 0
    for i in idx:
        n = len(gen[i].prompt) + len(results[i].tokens)
        if batch and rows + n > ROWS:
            yield batch
            batch, rows = [], 0
        batch.append(i)
        rows += n
    if batch:
        yield batch
