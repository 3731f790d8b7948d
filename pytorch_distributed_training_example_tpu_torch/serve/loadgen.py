"""Open-loop Poisson load generator for the serving engine.

The port's copy of ``pytorch_distributed_training_example_tpu/serve/
loadgen.py``, identical but for the ``Request`` it builds: the same seed
gives the same stream, byte for byte, in both packages.

OPEN loop: arrival times are drawn up front from a seeded exponential
inter-arrival process and never react to engine backpressure — the
generator keeps "sending" on schedule even while the engine is saturated,
which is what makes saturation-mode p99s honest (a closed loop would
self-throttle and hide the queueing delay).

Everything is seeded through one ``np.random.default_rng(seed)``: same
seed, same request stream, same page-table evolution — serve runs diff
bit-for-bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pytorch_distributed_training_example_tpu_torch.serve.engine import Request


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Shape of the synthetic request stream."""

    num_requests: int = 32
    rate: float = 0.0            # requests/s; <= 0 means all arrive at t=0
    prompt_len_min: int = 4
    prompt_len_max: int = 24
    max_new_min: int = 4
    max_new_max: int = 24
    vocab_size: int = 512
    eos_id: int | None = None    # None: length-bounded generation only
    seed: int = 0
    # Skewed shared-prefix workload (the realistic serving distribution:
    # a handful of system prompts / few-shot templates dominate traffic).
    # num_templates > 0 prepends a template prefix to every prompt, with
    # template popularity Zipf-distributed: p(rank k) ∝ 1 / k**zipf_a.
    num_templates: int = 0
    zipf_a: float = 1.2
    prefix_len_min: int = 16
    prefix_len_max: int = 32


def generate_requests(spec: LoadSpec) -> list[Request]:
    """The full request stream, arrival-time sorted. ``rate <= 0`` is the
    saturation configuration: every request is available immediately."""
    rng = np.random.default_rng(spec.seed)
    if spec.rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / spec.rate,
                                             spec.num_requests))
    else:
        arrivals = np.zeros(spec.num_requests)
    templates: list[list[int]] = []
    weights = None
    if spec.num_templates > 0:
        for _ in range(spec.num_templates):
            tlen = int(rng.integers(spec.prefix_len_min,
                                    spec.prefix_len_max + 1))
            templates.append(rng.integers(1, spec.vocab_size, tlen).tolist())
        # Explicit ranked-probability Zipf (``rng.zipf`` is unbounded).
        ranks = np.arange(1, spec.num_templates + 1, dtype=np.float64)
        weights = ranks ** -spec.zipf_a
        weights /= weights.sum()
    out = []
    for i in range(spec.num_requests):
        plen = int(rng.integers(spec.prompt_len_min, spec.prompt_len_max + 1))
        prompt = rng.integers(1, spec.vocab_size, plen).tolist()
        if templates:
            t = int(rng.choice(spec.num_templates, p=weights))
            prompt = templates[t] + prompt
        max_new = int(rng.integers(spec.max_new_min, spec.max_new_max + 1))
        out.append(Request(request_id=f"req{i:04d}", prompt=prompt,
                           max_new_tokens=max_new, eos_id=spec.eos_id,
                           arrival_time=float(arrivals[i])))
    return out


class OpenLoopDriver:
    """Feed a request stream into an engine on its arrival schedule.

    The caller owns the clock (pass elapsed seconds since the run began)
    so tests can drive virtual time; ``pump`` submits everything whose
    arrival time has passed and returns how many were submitted.
    """

    def __init__(self, requests: list[Request]):
        self._pending = sorted(requests, key=lambda r: r.arrival_time)
        self._cursor = 0

    @property
    def remaining(self) -> int:
        return len(self._pending) - self._cursor

    def pump(self, engine, now: float) -> int:
        sent = 0
        while (self._cursor < len(self._pending)
               and self._pending[self._cursor].arrival_time <= now):
            engine.submit(self._pending[self._cursor])
            self._cursor += 1
            sent += 1
        return sent
