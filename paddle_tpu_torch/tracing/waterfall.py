"""Per-request token-latency waterfall: TTFT, per-token TPOT, jitter.

A copy of ``paddle_tpu.tracing.waterfall`` (jax-free) for the PyTorch port.

The decode engine's spans time *iterations* (a prefill chunk, a decode
step, a verify step); users experience *tokens*. This module converts one
into the other, per request:

- **TTFT** — submit → first generated token (queue wait + prefill);
- **TPOT** — per-token latency after the first. Speculation-aware by
  construction: the engine reports each iteration as "``n`` tokens landed
  at ``t``", and an iteration that landed ``n`` tokens ``dt`` after the
  previous one books ``n`` TPOT samples of ``dt/n`` each — a verify step
  that accepts 4 tokens books 4 samples, so spec-on and spec-off runs
  produce one sample per generated token and stay comparable;
- **jitter** — the population stdev of a request's TPOT samples.

The engine calls :func:`start` at submit, :func:`on_tokens` once per
iteration that appended tokens, and :func:`finish` at terminal state;
:func:`on_tokens` returns the booked ``(ttft_s, tpot_samples)`` so the
caller can feed the ``serving.decode.ttft_seconds`` /
``serving.decode.tpot_seconds`` histogram families without re-deriving
them. Finished waterfall docs stay retrievable (bounded, oldest evicted)
through :func:`doc`.

All timestamps are ``time.perf_counter()`` seconds — the tracing
timebase — so waterfall events line up with spans in the merged trace.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.core import locks

__all__ = [
    "MAX_DOCS",
    "start",
    "on_tokens",
    "finish",
    "doc",
    "rids",
    "reset",
]

# bounded doc store: enough to inspect a burst, small enough to forget
MAX_DOCS = 1024


class _Doc:
    __slots__ = ("rid", "meta", "t_submit_pc", "t_first_token_pc",
                 "t_last_token_pc", "ttft_s", "tpot_s", "events",
                 "tokens", "finished", "reason")

    def __init__(self, rid: str, t_submit_pc: float, meta: Dict[str, str]):
        self.rid = rid
        self.meta = meta
        self.t_submit_pc = t_submit_pc
        self.t_first_token_pc: Optional[float] = None
        self.t_last_token_pc: Optional[float] = None
        self.ttft_s: Optional[float] = None
        self.tpot_s: List[float] = []
        self.events: List[dict] = []
        self.tokens = 0
        self.finished = False
        self.reason: Optional[str] = None


_lock = locks.Lock("tracing.waterfall")
_docs: "OrderedDict[str, _Doc]" = OrderedDict()


def start(rid: str, t_submit_pc: float, **meta) -> None:
    """Open a waterfall for one request at its submit timestamp."""
    if not rid:
        return
    with _lock:
        _docs.pop(rid, None)
        while len(_docs) >= MAX_DOCS:
            _docs.popitem(last=False)
        _docs[rid] = _Doc(rid, float(t_submit_pc),
                          {k: str(v) for k, v in meta.items() if v})


def on_tokens(rid: str, t_pc: float, n: int,
              phase: str = "decode") -> Tuple[Optional[float], List[float]]:
    """Book ``n`` tokens landing at ``t_pc`` (one engine iteration).
    Returns ``(ttft_s, tpot_samples)`` — ``ttft_s`` is non-None only on
    the iteration that produced the request's first token; every token
    after the first yields exactly one TPOT sample (``dt/n`` each for an
    ``n``-token iteration). Unknown rids are ignored."""
    if n <= 0:
        return None, []
    with _lock:
        d = _docs.get(rid)
        if d is None or d.finished:
            return None, []
        t_pc = float(t_pc)
        ttft: Optional[float] = None
        samples: List[float] = []
        remaining = n
        if d.t_first_token_pc is None:
            d.t_first_token_pc = t_pc
            ttft = d.ttft_s = max(0.0, t_pc - d.t_submit_pc)
            remaining -= 1
        if remaining > 0:
            # dt since the previous token-landing iteration, split evenly
            # over this iteration's tokens (the speculation contract)
            dt = max(0.0, t_pc - (d.t_last_token_pc
                                  if d.t_last_token_pc is not None
                                  else d.t_first_token_pc))
            samples = [dt / remaining] * remaining
            d.tpot_s.extend(samples)
        d.t_last_token_pc = t_pc
        d.tokens += n
        d.events.append({"t_pc": t_pc, "n": n, "phase": phase})
        return ttft, samples


def finish(rid: str, t_pc: float, reason: str) -> None:
    """Mark a request's waterfall terminal (eos / length / cancel / ...)."""
    with _lock:
        d = _docs.get(rid)
        if d is None or d.finished:
            return
        d.finished = True
        d.reason = str(reason)
        d.events.append({"t_pc": float(t_pc), "n": 0, "phase": "finish"})


def _stats(samples: List[float]) -> dict:
    if not samples:
        return {"count": 0, "mean_s": None, "p50_s": None, "p99_s": None,
                "jitter_s": None}
    s = sorted(samples)
    n = len(s)
    mean = sum(s) / n
    var = sum((x - mean) ** 2 for x in s) / n
    return {
        "count": n,
        "mean_s": mean,
        "p50_s": s[min(n - 1, int(0.50 * n))],
        "p99_s": s[min(n - 1, int(0.99 * n))],
        "jitter_s": math.sqrt(var),
    }


def doc(rid: str) -> Optional[dict]:
    """One request's waterfall document (None when unknown/evicted)."""
    with _lock:
        d = _docs.get(rid)
        if d is None:
            return None
        return {
            "rid": d.rid,
            **d.meta,
            "t_submit_pc": d.t_submit_pc,
            "t_first_token_pc": d.t_first_token_pc,
            "t_last_token_pc": d.t_last_token_pc,
            "ttft_s": d.ttft_s,
            "tokens": d.tokens,
            "tpot_s": list(d.tpot_s),
            "tpot": _stats(d.tpot_s),
            "events": [dict(e) for e in d.events],
            "finished": d.finished,
            "reason": d.reason,
        }


def rids(finished_only: bool = False) -> List[str]:
    """Known request ids, oldest first."""
    with _lock:
        return [r for r, d in _docs.items()
                if d.finished or not finished_only]


def reset() -> None:
    with _lock:
        _docs.clear()
