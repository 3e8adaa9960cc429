"""Synchronous batched serving (twin of ``repro.serve.engine``).

:meth:`ServeEngine.generate` prefills a (B, S) prompt batch into a fresh
contiguous cache of ``max_len`` rows and decodes ``n_steps`` tokens for
every row in lockstep; :meth:`ServeEngine.run` replays a trace through it
in FIFO groups.  With ``batch=1`` it is the greedy oracle the paged
engine is held to.  With ``cfg.use_kernels`` every prefill runs the
``flash_attention`` kernel and every decode step the ``decode_attention``
kernel, once per layer.

What differs from the reference is the device side.  The reference jits
one prefill and one decode step per bucket; the port runs them eagerly
and writes each decode step's K/V row into the cache in place.  The
sampled tokens stay on the device between steps and reach the host once,
at the end of ``generate``.  Temperature sampling draws from one
``torch.Generator`` seeded with ``seed`` on the engine's device; only
greedy decoding is held to the reference.  ``generate(extras=...)``
and ``prefill(extras=...)`` add media or frame embeddings to the prefill
batch, as the reference's ``generate(extras=...)`` does, so the
cross-attention and encoder-decoder models generate here too; neither
engine's ``run`` takes media, in either package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import decode_step, prefill
from repro_torch.serve.api import (Request, RequestResult, RunStats,
                                   as_requests, sample)

__all__ = ["ServeEngine", "GenerateResult"]


@dataclasses.dataclass
class GenerateResult:
    tokens: np.ndarray          # (B, n_generated)
    prompt_len: int
    steps: int


class ServeEngine:
    """Synchronous engine over one ``max_len`` bucket.

    ``params`` must live on ``device`` (default ``"cuda"``; asking for
    CUDA without it raises).  ``prefill_pad=True`` right-pads every
    prompt to ``max_len`` before prefilling and takes the logits at the
    true last token, as the reference's option does (padded rows are
    causally masked away and overwritten by decode)."""

    def __init__(self, cfg: ModelConfig, params, *, max_len: int = 512,
                 prefill_pad: bool = False,
                 device: Union[str, torch.device, None] = "cuda"):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device} but "
                             f"the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.prefill_pad = prefill_pad

    def prefill(self, tokens: np.ndarray, extras: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, List[dict]]:
        """Prefill a (B, S) prompt batch into a fresh cache; returns the
        (B, V) logits of each prompt's last token and the cache.
        ``extras`` adds entries to the prefill batch: ``"media"`` (B, M,
        D) for a cross-attention model, ``"frames"`` (B, F, D) for an
        encoder-decoder (numpy arrays or tensors, moved to the engine's
        device)."""
        B, S = tokens.shape
        if self.prefill_pad:
            toks = np.pad(tokens, ((0, 0), (0, self.max_len - S)))
            last_pos = S - 1
        else:
            toks, last_pos = tokens, None
        batch = {"tokens": torch.tensor(np.asarray(toks, np.int32),
                                        device=self.device)}
        for k, v in (extras or {}).items():
            batch[k] = torch.as_tensor(v, device=self.device)
        logits, cache = prefill(self.cfg, self.params, batch,
                                max_len=self.max_len, last_pos=last_pos)
        return logits[:, -1], cache

    def decode(self, cache: List[dict], tokens: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One decode step of (B, 1) ``tokens`` at position ``pos``, their
        K/V rows written into ``cache``; returns the (B, V) logits."""
        logits, _ = decode_step(self.cfg, self.params, cache, tokens, pos)
        return logits[:, -1]

    def generate(self, tokens: np.ndarray, *, n_steps: int = 32,
                 temperature: float = 0.0, seed: int = 0,
                 extras: Optional[Dict] = None) -> GenerateResult:
        """tokens: (B, S) int32 prompt batch -> greedy/temperature decode;
        ``extras`` as in :meth:`prefill`.  Raises ``ValueError`` when
        S + n_steps exceeds ``max_len``."""
        tokens = np.asarray(tokens, np.int32)
        B, S = tokens.shape
        if S + n_steps > self.max_len:
            raise ValueError(
                f"request does not fit its bucket: prompt length {S} + "
                f"n_steps {n_steps} = {S + n_steps} exceeds this engine's "
                f"max_len bucket of {self.max_len} (build a ServeEngine "
                f"with max_len >= {S + n_steps} or shorten the request)")
        logits, cache = self.prefill(tokens, extras)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        tok = sample(logits, temperature, gen)[:, None]
        out: List[torch.Tensor] = []
        for i in range(n_steps):
            out.append(tok)
            logits = self.decode(cache, tok, S + i)
            tok = sample(logits, temperature, gen)[:, None]
        return GenerateResult(
            tokens=torch.cat(out, dim=1).cpu().numpy().astype(np.int32),
            prompt_len=S, steps=n_steps)

    def teacher_forced_logits(self, prompt: np.ndarray,
                              tokens: Sequence[int]) -> List[torch.Tensor]:
        """The (V,) logits behind each token of a stream: the prompt
        prefilled alone, then ``tokens`` fed back one decode step at a
        time (the steps ``run(batch=1)`` takes)."""
        prompt = np.asarray(prompt, np.int32).reshape(1, -1)
        logits, cache = self.prefill(prompt)
        out = [logits[0]]
        s = prompt.shape[1]
        for t, tok in enumerate(list(tokens)[:-1]):
            tt = torch.tensor([[tok]], dtype=torch.int32, device=self.device)
            out.append(self.decode(cache, tt, s + t)[0])
        return out

    def run(self, requests: Sequence[Request], *, temperature: float = 0.0,
            seed: int = 0, batch: int = 1
            ) -> Tuple[List[RequestResult], RunStats]:
        """Replay a trace synchronously: FIFO groups of up to ``batch``
        requests, every prompt right-padded to the group max, every
        request decoded for the group-max step count and sliced to its
        own ``n_steps`` (the reference's padding and convoy semantics:
        a shorter prompt's logits are taken at the padded last position).

        ``batch=1`` serves each request alone and is the greedy oracle:
        request i's tokens equal ``generate(prompt[None], n_steps)``.
        Arrival ticks only order the groups; ``admitted`` and
        ``finished`` report the group index, and every token's emit time
        is its group's completion time."""
        if batch < 1:
            raise ValueError(f"batch={batch} < 1")
        reqs = as_requests(requests)
        order = sorted(range(len(reqs)), key=lambda i: (reqs[i].arrival, i))
        results: List[Optional[RequestResult]] = [None] * len(reqs)
        decode_steps = 0
        groups = [order[i:i + batch] for i in range(0, len(order), batch)]
        for gi, group in enumerate(groups):
            s_max = max(reqs[i].prompt.shape[0] for i in group)
            n_max = max(reqs[i].n_steps for i in group)
            padded = np.stack(
                [np.pad(reqs[i].prompt, (0, s_max - reqs[i].prompt.shape[0]))
                 for i in group])
            t_admit = time.perf_counter()
            gen = self.generate(padded, n_steps=n_max,
                                temperature=temperature, seed=seed)
            t_done = time.perf_counter()
            decode_steps += n_max
            for row, i in enumerate(group):
                r = reqs[i]
                results[i] = RequestResult(
                    tokens=np.asarray(gen.tokens[row, :r.n_steps], np.int32),
                    prompt_len=r.prompt.shape[0],
                    arrival=r.arrival, admitted=gi, finished=gi,
                    emit_times=[t_done] * r.n_steps, admit_time=t_admit)
        stats = RunStats(requests=len(reqs),
                         tokens=sum(r.n_steps for r in reqs),
                         decode_steps=decode_steps, batches=len(groups))
        return [r for r in results if r is not None], stats
